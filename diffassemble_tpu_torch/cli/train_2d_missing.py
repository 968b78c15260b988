"""2D missing-pieces CLI — port of the JAX package's ``cli/train_2d_missing.py``
(the reference's ``train_script_missing.py``): the 2D flags with ``--missing``
(default 20) percent of every puzzle's pieces removed.

    python -m diffassemble_tpu_torch.cli.train_2d_missing -dataset synthetic -puzzle_sizes 6
"""

import argparse

from .common import add_2d_args, run_2d


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_2d_args(ap)
    ap.set_defaults(missing=20)
    args = ap.parse_args()
    print(args)
    run_2d(args)


if __name__ == "__main__":
    main()
