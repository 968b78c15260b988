"""2D rotation-puzzle CLI — port of the JAX package's ``cli/train_2d_rot.py``
(the reference's ``train_script_rot.py``): the rotation recipe with
rotation=True forced and the launch script's defaults (predict_xstart, degree
60%, 8 virt nodes, resnet18equiv + exophormer). The port has only the
efficientnet_b0 backbone so far, so pass ``--backbone efficientnet_b0``:

    python -m diffassemble_tpu_torch.cli.train_2d_rot --backbone efficientnet_b0 \
        -dataset synthetic -puzzle_sizes 30 --degree 10% --unique_graph true \
        -batch_size 8 --aux_loss_weight 0.1 --run_dir runs/rot30
"""

import argparse

from .common import add_2d_args, run_2d


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    add_2d_args(ap)
    ap.set_defaults(
        rotation=True,
        predict_xstart=True,
        degree="60%",
        virt_nodes=8,
        backbone="resnet18equiv",
        architecture="exophormer",
    )
    args = ap.parse_args()
    args.rotation = True
    print(args)
    run_2d(args)


if __name__ == "__main__":
    main()
