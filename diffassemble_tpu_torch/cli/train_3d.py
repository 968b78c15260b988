"""3D Breaking-Bad CLI — port of the JAX package's ``cli/train_3d.py``: the
SE(3) double-diffusion pipeline with per-category metrics and the rmse_t_AVG
checkpoint monitor (mode min).

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; the CPU
only when asked for). Without ``--evaluate`` it trains: the model is built
from the flags, as the JAX CLI builds it, and ``Trainer.fit`` runs with the
fragment adapter (a sanity evaluation of one batch, an evaluation and a
checkpoint every 1000 steps, the latest checkpoint at the end, resume from
the run's latest checkpoint, EMA with ``--ema_decay``, the dead-gradient
tripwire). ``--evaluate true`` runs ``Trainer.evaluate`` over the held-out
split, ``--num_iter`` times (mean and std), with the latest checkpoint's
``eval_params`` of ``--run_dir`` or, with ``--checkpoint_path``, that
checkpoint's live params, as the JAX CLI does; unlike the JAX CLI, the model
is then the run's ``config.json`` when the run has one, so the widths are
the checkpoint's whatever the flags say (the data and evaluation flags are
always read). Without a checkpoint it evaluates the seeded weights and
``encoder_init``, as the JAX CLI's init does.

    python -m diffassemble_tpu_torch.cli.train_3d --dataset synthetic --run_dir runs/3d \
        --backbone vn_dgcnn_rich --batch_size 16 --num_points 512 --max_num_part 8 \
        --rel_pose_weight 0.5 --rel_condition 1 --aux_pose_weight 0.5 --rot_pt_l2_weight 1.0 \
        --encoder_init weights/vn_dgcnn_rich_rel3d_512.npz --device cuda

``--backbone`` takes every encoder of the JAX package's table (``BACKBONES``),
and ``--equiv_inv_mp 1`` (or ``--use_vn_dgcnn_equiv_inv_mp``) trains and
evaluates with split equivariant/invariant message passing.

``--gpus N`` trains data-parallel over min(N, the run's processes) ranks,
one process per card (``torchrun --nproc_per_node N -m
diffassemble_tpu_torch.cli.train_3d --gpus N ...``): the loss's draws are
drawn for the whole batch on every rank and the relative-pose losses divide
by the whole batch's counts (``parallel/mesh.py:data_parallel_loss``), so a
step is the single-process step on the whole batch. ``--evaluate true
--export_meshes`` first samples the first 4 held-out objects with their
trajectories and writes, per object, a ``.ply`` of the posed parts at every
step and the ``_traj.npz`` under ``<run_dir>/meshes`` (as the JAX CLI, the
flag does nothing without ``--evaluate``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .common import str2bool

# the JAX package's point encoders (nn/pointnet.py's table)
BACKBONES = ("pointnet", "pointnet_inv", "pointnet_plus", "vn_dgcnn", "vn_dgcnn_inv", "vn_dgcnn_equiv_inv",
             "vn_dgcnn_rich", "vnn")


def add_3d_args(ap: argparse.ArgumentParser) -> None:
    """The JAX CLI's flag surface, plus ``--device``."""
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--gpus", type=int, default=1)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dataset", default="breaking-bad", choices=["breaking-bad", "synthetic"])
    ap.add_argument("--sampling", default="DDIM", choices=["DDPM", "DDIM"])
    ap.add_argument("--inference_ratio", type=int, default=10)
    ap.add_argument("--n_layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--classifier_free_w", type=float, default=0.2)
    ap.add_argument("--classifier_free_prob", type=float, default=0.0)
    ap.add_argument("--checkpoint_path", type=str, default="")
    ap.add_argument("--run_dir", type=str, default="")
    ap.add_argument("--noise_weight", type=float, default=0.0)
    ap.add_argument("--predict_xstart", type=str2bool, default=True)
    ap.add_argument("--backbone", type=str, default="vn_dgcnn", choices=BACKBONES,
                    help="point encoder (nn/pointnet.py:make_point_encoder)")
    ap.add_argument("--architecture", type=str, default="transformer")
    ap.add_argument("--freeze_backbone", type=str2bool, default=False)
    ap.add_argument("--loss_type", type=str, default="all")
    ap.add_argument("--category", type=str, default="")
    ap.add_argument("--evaluate", type=str2bool, default=False)
    ap.add_argument("--max_steps", type=int, default=100_000)
    ap.add_argument("--max_num_part", type=int, default=20)
    ap.add_argument("--min_num_part", type=int, default=2)
    ap.add_argument("--use_6dof_rot", action="store_true", default=False)
    ap.add_argument("--use_vn_dgcnn_equiv_inv_mp", "--equiv_inv_mp", type=str2bool, nargs="?", const=True,
                    default=False,
                    help="equiv/inv split message passing (DualStreamGraphTransformer; a vn_dgcnn backbone becomes "
                         "vn_dgcnn_equiv_inv): bare, as the JAX CLI's flag, or with a value (--equiv_inv_mp 1)")
    ap.add_argument("--missing", type=int, default=0)
    ap.add_argument("--num_iter", type=int, default=1)
    ap.add_argument("--export_meshes", action="store_true", default=False)
    ap.add_argument("--compute_dtype", type=str, default="bfloat16")
    ap.add_argument("--aux_pose_weight", type=float, default=0.0)
    ap.add_argument("--rot_pt_l2_weight", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data_dir", type=str, default=None)
    ap.add_argument("--encoder_init", type=str, default="",
                    help="pose-pretrained point-encoder npz (the JAX package's flattened parameter tree)")
    ap.add_argument("--synthetic_canonical", type=float, default=0.6,
                    help="weight of the fixed canonical deformation field in SyntheticFractures")
    ap.add_argument("--synthetic_voronoi", type=str2bool, default=True,
                    help="connected Voronoi-cell parts (True) vs plane-cut unions (False)")
    ap.add_argument("--train_n", type=int, default=512)
    ap.add_argument("--test_n", type=int, default=64)
    ap.add_argument("--rel_pose_weight", type=float, default=0.0)
    ap.add_argument("--rel_condition", type=str2bool, default=False)
    ap.add_argument("--contact_thresh", type=float, default=0.1)
    ap.add_argument("--wall_detail", type=float, default=0.0,
                    help="corrugation amplitude of synthetic fracture walls")
    ap.add_argument("--wall_boost", type=int, default=1,
                    help="wall point-density multiplier in SyntheticFractures")
    ap.add_argument("--wall_surface", type=str2bool, default=False,
                    help="project wall samples onto the shared Voronoi sheet")
    ap.add_argument("--wall_freq", type=float, default=14.0, help="wall corrugation frequency")
    ap.add_argument("--num_points", type=int, default=1000, help="points sampled per part")
    ap.add_argument("--ema_decay", type=float, default=0.0,
                    help="EMA of params for eval (0 = off, reference parity)")
    ap.add_argument("--warmup_steps", type=int, default=500, help="linear LR warmup")
    ap.add_argument("--deadline_margin", type=float, default=None,
                    help="wind down this many seconds before the round's cutoff (utils/deadline.py)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; the CPU runs only when asked for (--device cpu)")


def config_from_args(args):
    from ..models.diffusion_3d import Diffusion3DConfig

    return Diffusion3DConfig(
        steps=args.steps,
        sampling=args.sampling.lower(),
        inference_ratio=args.inference_ratio,
        mean_type="xstart" if args.predict_xstart else "epsilon",
        noise_weight=args.noise_weight,
        loss_type=args.loss_type,
        backbone=args.backbone,
        architecture=args.architecture,
        n_layers=args.n_layers,
        max_num_part=args.max_num_part,
        use_6dof=bool(args.use_6dof_rot),
        equiv_inv_mp=bool(args.use_vn_dgcnn_equiv_inv_mp),
        freeze_backbone=bool(args.freeze_backbone),
        aux_pose_weight=args.aux_pose_weight,
        rot_pt_l2_weight=args.rot_pt_l2_weight,
        encoder_init=args.encoder_init,
        compute_dtype=args.compute_dtype,
        rel_pose_weight=args.rel_pose_weight,
        rel_condition=bool(args.rel_condition),
        contact_thresh=args.contact_thresh,
        warmup_steps=args.warmup_steps,
    )


def datasets_3d(args):
    """(train set, test set, category names) of the flags."""
    from ..data.breaking_bad import get_dataset_3d

    return get_dataset_3d(
        args.dataset,
        data_dir=args.data_dir,
        category=args.category,
        num_points=args.num_points,
        min_num_part=args.min_num_part,
        max_num_part=args.max_num_part,
        train_n=args.train_n,
        test_n=args.test_n,
        seed=args.seed,
        canonical=args.synthetic_canonical,
        voronoi=args.synthetic_voronoi,
        wall_detail=args.wall_detail,
        wall_boost=args.wall_boost,
        wall_surface=args.wall_surface,
        wall_freq=args.wall_freq,
    )


def build_3d(args, config=None):
    """(model, train set, test set, category names); the model from
    ``config`` (a ``Diffusion3DConfig``) or, without one, from the flags."""
    from ..models.diffusion_3d import Diffusion3D

    model = Diffusion3D(config or config_from_args(args), device=args.device, seed=args.seed)
    return (model, *datasets_3d(args))


def saved_config(path: str):
    """The ``config.json`` near a run dir or checkpoint path as a
    ``Diffusion3DConfig``, or None."""
    from ..models.diffusion_3d import Diffusion3DConfig
    from ..train.checkpoint import load_config_near

    try:
        return Diffusion3DConfig(**load_config_near(path))
    except FileNotFoundError:
        return None


def run_3d(args) -> dict[str, tuple[float, float]] | None:
    """Train, or evaluate (``--evaluate true``): then the per-category
    metrics' mean and std over ``--num_iter`` evaluations, printed and
    returned."""
    import torch

    from ..parallel.distributed import initialize
    from ..parallel.mesh import make_mesh
    from ..train.checkpoint import restore_explicit
    from ..train.train_state import TrainState, eval_params
    from ..train.trainer import Trainer, fragment_adapter
    from .common import device_count

    initialize(device=args.device)  # no-op for a single process
    if args.gpus > device_count():
        print(f"--gpus {args.gpus}: this run has {device_count()} process(es), one device each; "
              f"using {device_count()}", flush=True)
    run_dir = args.run_dir or f"runs/3d-{args.dataset}-{args.backbone}"
    config = saved_config(args.checkpoint_path or run_dir) if args.evaluate else None
    model, train_ds, test_ds, cats = build_3d(args, config)
    trainer = Trainer(
        model,
        run_dir=run_dir,
        max_steps=args.max_steps,
        batch_size=args.batch_size,
        seed=args.seed,
        monitor="rmse_t_AVG",
        monitor_mode="min",
        adapter=fragment_adapter(args.max_num_part, cats, missing_perc=args.missing, seed=args.seed),
        deadline_margin=args.deadline_margin,
        ema_decay=args.ema_decay or None,
        mesh=make_mesh(min(args.gpus, device_count()), tp=1),
    )
    if not args.evaluate:
        trainer.fit(train_ds, test_ds)
        return None
    # the JAX CLI collates one sample to initialise its model: the same draw
    # keeps the adapter's rng in step with it
    trainer.adapter.collate([test_ds[0]], args.max_num_part)
    template = TrainState(dict(model.named_parameters()), {}, 0,
                          torch.Generator(device=model.device).manual_seed(args.seed))
    if args.checkpoint_path:
        params = restore_explicit(args.checkpoint_path, template).params
    else:
        restored = trainer.ckpt.restore(template)
        if restored is None:
            print(f"no checkpoint under {Path(run_dir) / 'checkpoints'}: evaluating the seeded weights", flush=True)
            model.init(args.seed)
            params = template.params
        else:
            params = eval_params(restored)
    if args.export_meshes:
        export_meshes(model, params, trainer.adapter.collate([test_ds[i] for i in range(min(4, len(test_ds)))],
                                                             args.max_num_part), Path(run_dir) / "meshes")
    runs = [trainer.evaluate(params, test_ds, tag=f"test_{it}") for it in range(args.num_iter)]
    agg = {k: (float(np.mean([r[k] for r in runs])), float(np.std([r[k] for r in runs]))) for k in runs[0]}
    print({k: f"{m:.4f}±{s:.4f}" for k, (m, s) in agg.items()}, flush=True)
    return agg


def export_meshes(model, params: dict, nb, out_dir: Path) -> None:
    """Sample host batch ``nb`` with ``params`` (a generator seeded 1) keeping
    the trajectory, and export each object's (``export_fragment_trajectory``:
    ``obj<b>_step<s>.ply`` and ``obj<b>_traj.npz``) under ``out_dir``."""
    import torch

    from ..data.batch import FragmentBatch
    from ..train.trainer import swapped_params
    from ..utils.viz import export_fragment_trajectory

    batch = FragmentBatch(*nb).to(model.device)
    with swapped_params(model, params):
        traj = model.sample(batch, torch.Generator(device=model.device).manual_seed(1),
                            keep_trajectory=True).trajectory.cpu().numpy()  # (S, B, P, C)
    for b in range(traj.shape[1]):
        export_fragment_trajectory(out_dir, np.asarray(nb.pcds[b]), traj[:, b], np.asarray(nb.node_mask[b]),
                                   name=f"obj{b}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_3d_args(ap)
    args = ap.parse_args()
    print(args)
    run_3d(args)


if __name__ == "__main__":
    main()
