"""2D train/eval CLI — port of the JAX package's ``cli/train_2d.py`` (the
reference's ``train_script.py``): dataset selection, the continuous model,
training loop, eval mode (``--evaluate true``).

Usage (on the card; add ``--device cpu`` to run on the CPU):
    python -m diffassemble_tpu_torch.cli.train_2d -dataset synthetic -puzzle_sizes 6
"""

import argparse

from .common import add_2d_args, run_2d


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    add_2d_args(ap)
    args = ap.parse_args()
    print(args)
    run_2d(args)


if __name__ == "__main__":
    main()
