"""Shared CLI plumbing — port of the JAX package's ``cli/common.py``: the
reference's argparse surface → config + datasets + trainer.

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; the CPU
only when asked for). ``--discrete`` builds the D3PM models (with
``--rotation``, the two-chain one; ``--cold_diffusion``, ``--only_rotation``),
K = ``puzzle_sizes[0]``² classes. The backbones are efficientnet_b0 and the
equivariant ResNets; "tiny" and "convnet" are not ported yet (ROADMAP Queue
1 item 6). ``-gpus N``
trains data-parallel over min(N, the run's processes) ranks: launch one
process per card, e.g. ``torchrun --nproc_per_node N -m
diffassemble_tpu_torch.cli.train_2d_rot ...``; a single process uses one
device. Unlike the JAX CLI, ``--unique_graph`` reaches the dataset (one
fixed expander per puzzle size).
"""

from __future__ import annotations

import argparse

from ..models.diffusion_2d import Diffusion2D, Diffusion2DConfig
from ..models.diffusion_2d_discrete import DiscreteDiffusion2D, DiscreteDiffusion2DConfig, DiscreteDiffusion2DRot
from ..nn.visual import BACKBONES


def percent(value: str):
    """'60%' stays a percent string; otherwise int (reference Percent type)."""
    s = str(value)
    if s.endswith("%"):
        int(s[:-1])  # validate
        return s
    return int(s)


def str2bool(value) -> bool:
    """Boolean flag parser (argparse ``type=bool`` takes "False" as true)."""
    if isinstance(value, bool):
        return value
    s = str(value).strip().lower()
    if s in ("true", "1", "yes", "y", "t"):
        return True
    if s in ("false", "0", "no", "n", "f", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def add_2d_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-batch_size", type=int, default=6)
    ap.add_argument("-gpus", type=int, default=1,
                    help="data-parallel devices, at most the run's processes (one per card)")
    ap.add_argument("-steps", type=int, default=300)
    ap.add_argument("-max_epochs", type=int, default=1000)
    ap.add_argument("-max_steps", type=int, default=100_000)
    ap.add_argument(
        "-dataset",
        default="wikiart",
        choices=["celeba", "wikiart", "cifar100", "imagenet", "synthetic",
                 "synthetic_art"],
    )
    ap.add_argument("-sampling", default="DDIM", choices=["DDPM", "DDIM"])
    ap.add_argument("-inference_ratio", type=int, default=10)
    ap.add_argument("--degree", type=percent, default="100%")
    ap.add_argument("--virt_nodes", type=int, default=4)
    ap.add_argument("--unique_graph", type=str2bool, default=False)
    ap.add_argument("--inf_fully", type=str2bool, default=False)
    ap.add_argument("--n_layers", type=int, default=4)
    ap.add_argument("-puzzle_sizes", nargs="+", default=[6], type=int)
    ap.add_argument("--classifier_free_w", type=float, default=0.2)
    ap.add_argument("--classifier_free_prob", type=float, default=0.0)
    ap.add_argument("--checkpoint_path", type=str, default="")
    ap.add_argument("--run_dir", type=str, default="")
    ap.add_argument("--noise_weight", type=float, default=0.0)
    ap.add_argument("--predict_xstart", type=str2bool, default=False)
    ap.add_argument("--rotation", type=str2bool, default=False)
    ap.add_argument("--only_rotation", action="store_true", default=False)
    ap.add_argument("--freeze_backbone", type=str2bool, default=False)
    # reference default is True (train_script.py:282) with weights fetched by
    # timm; this build has no egress, so pretrained is opt-in and requires a
    # locally converted weights file (scripts/convert_efficientnet.py)
    ap.add_argument("--visual_pretrained", type=str2bool, default=False)
    ap.add_argument("--visual_weights", type=str, default="weights/efficientnet_b0_features.npz")
    ap.add_argument("--encoder_init", type=str, default="",
                    help="npz of a pretrained encoder (the JAX package's flattened parameter tree)")
    ap.add_argument("--discrete", type=str2bool, default=False)
    ap.add_argument("--cold_diffusion", type=str2bool, default=False)
    ap.add_argument("--loss_type", type=str, default="huber")
    ap.add_argument("--backbone", type=str, default="efficientnet_b0")
    ap.add_argument("--architecture", type=str, default="transformer")
    ap.add_argument("--all_equivariant", type=str2bool, default=False)
    ap.add_argument("--evaluate", type=str2bool, default=False)
    ap.add_argument("--acc_grad", type=int, default=0)
    ap.add_argument("--missing", type=int, default=0)
    ap.add_argument("--compute_dtype", type=str, default="bfloat16")
    ap.add_argument("--aux_loss_weight", type=float, default=0.0)
    ap.add_argument(
        "--warmup_steps", type=int, default=500,
        help="linear LR warmup; 0 = reference HF-Adafactor schedule (which can "
        "collapse predict-x0 recipes into the grid-mean basin)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_root", type=str, default=None)
    ap.add_argument("--ema_decay", type=float, default=0.0,
                    help="EMA of params for eval (0 = off, reference parity)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; the CPU runs only when asked for (--device cpu)")


def check_backbone(backbone: str) -> None:
    """Raise, naming its ROADMAP item, for a backbone the port does not have."""
    if backbone not in BACKBONES:
        raise NotImplementedError(
            f"backbone {backbone!r} is not ported yet (only {', '.join(BACKBONES)}): ROADMAP Queue 1 item 6")


def build_2d_model(args) -> Diffusion2D:
    """The continuous model, or with ``--discrete`` the D3PM one (the
    two-chain one with ``--rotation``), as the JAX CLI builds them; a loss
    type the model does not know falls back to huber, or cross_entropy."""
    check_backbone(args.backbone)
    common = dict(
        steps=args.steps,
        sampling=args.sampling.lower(),
        inference_ratio=args.inference_ratio,
        mean_type="xstart" if args.predict_xstart else "epsilon",
        rotation=bool(args.rotation),
        noise_weight=args.noise_weight,
        classifier_free_prob=args.classifier_free_prob,
        classifier_free_w=args.classifier_free_w,
        backbone=args.backbone,
        architecture=args.architecture,
        n_layers=args.n_layers,
        virt_nodes=args.virt_nodes,
        freeze_backbone=bool(args.freeze_backbone),
        visual_pretrained=bool(args.visual_pretrained),
        visual_weights=args.visual_weights,
        encoder_init=args.encoder_init,
        all_equivariant=bool(args.all_equivariant),
        warmup_steps=args.warmup_steps,
        aux_loss_weight=args.aux_loss_weight,
        compute_dtype=args.compute_dtype,
    )
    if args.discrete:
        dl = args.loss_type if args.loss_type in ("cross_entropy", "vb", "hybrid") else "cross_entropy"
        cfg = DiscreteDiffusion2DConfig(**common, n_classes=args.puzzle_sizes[0] ** 2, discrete_loss=dl,
                                        cold_diffusion=bool(args.cold_diffusion),
                                        only_rotation=bool(args.only_rotation))
        model_cls = DiscreteDiffusion2DRot if args.rotation else DiscreteDiffusion2D
        return model_cls(cfg, device=args.device, seed=args.seed)
    lt = args.loss_type if args.loss_type in ("huber", "l1", "l2") else "huber"
    return Diffusion2D(Diffusion2DConfig(**common, loss_type=lt), device=args.device, seed=args.seed)


def build_2d_datasets(args):
    from ..data.datasets import get_dataset

    return get_dataset(
        args.dataset,
        puzzle_sizes=list(args.puzzle_sizes),
        rotation=bool(args.rotation),
        degree=args.degree if args.degree != "100%" else -1,
        missing_perc=args.missing,
        unique_graph=bool(args.unique_graph),
        inf_fully=bool(args.inf_fully),
        data_root=args.data_root,
        seed=args.seed,
    )


def device_count() -> int:
    """The devices a run can use: one per process of its group."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def run_2d(args) -> None:
    from ..parallel.distributed import initialize
    from ..parallel.mesh import make_mesh
    from ..train.trainer import Trainer

    initialize(device=args.device)  # no-op for a single process
    model = build_2d_model(args)
    train_ds, test_ds, sizes = build_2d_datasets(args)
    run_dir = args.run_dir or f"runs/{args.dataset}-{'x'.join(map(str, args.puzzle_sizes))}"
    if args.gpus > device_count():
        print(f"-gpus {args.gpus}: this run has {device_count()} process(es), one device each; "
              f"using {device_count()}", flush=True)
    mesh = make_mesh(min(args.gpus, device_count()), tp=1)
    trainer = Trainer(
        model,
        run_dir=run_dir,
        max_steps=args.max_steps,
        batch_size=args.batch_size,
        accumulate=max(args.acc_grad, 1),
        seed=args.seed,
        ema_decay=args.ema_decay or None,
        mesh=mesh,
    )
    if args.evaluate:
        from ..train.train_state import eval_params

        state = trainer.new_state()
        if getattr(args, "checkpoint_path", ""):
            from ..train.checkpoint import restore_explicit

            # the live params, as the reference evaluates an explicit checkpoint
            params = restore_explicit(args.checkpoint_path, state).params
        else:
            restored = trainer.ckpt.restore(state)
            params = eval_params(restored if restored is not None else state)
        metrics = trainer.evaluate(params, test_ds, tag="test")
        print({k: round(v, 4) for k, v in metrics.items()})
        return
    trainer.fit(train_ds, test_ds)
