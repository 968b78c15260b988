"""3D missing-fragments CLI — port of the JAX package's
``cli/train_3d_missing.py``: ``cli/train_3d.py`` with ``--missing 20`` (that
share of each object's parts dropped, at most all but two) and
``--num_iter 3`` (the test repeated, mean and std) as defaults.

    python -m diffassemble_tpu_torch.cli.train_3d_missing --dataset synthetic --run_dir runs/3d-missing --device cuda
"""

import argparse

from .train_3d import add_3d_args, run_3d


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_3d_args(ap)
    ap.set_defaults(missing=20, num_iter=3)
    args = ap.parse_args()
    print(args)
    run_3d(args)


if __name__ == "__main__":
    main()
