"""Evaluate/predict CLI — port of the JAX package's ``cli/evaluate.py`` (the
reference's ``viz_script.py``): a run's checkpoint with the sampler's
settings overridden, sampled over the held-out split, the metrics of each
batch printed and every step's reconstruction saved.

The model is the run's ``config.json``, built by ``init`` (seeded weights,
``visual_pretrained``, ``encoder_init``) and then given the ``eval_params``
(the EMA average where the checkpoint keeps one, else the live params) of
``--run_dir``'s latest checkpoint, or of ``--checkpoint_path``; without a
checkpoint it evaluates the seeded weights. ``--calibrate_norm N`` pools the OrientationNorm statistics over N
training batches, freezes them for the evaluation and writes them to
``<run_dir>/norm_stats.npz``. ``--save_images`` writes, per puzzle, one
image per sampling step to ``--out_dir`` (default ``<run_dir>/preds``):
PNGs, or ``.npy`` pixels where PIL is missing.

    python -m diffassemble_tpu_torch.cli.evaluate --run_dir runs/rot30 --puzzle_sizes 30 \
        --batch_size 4 --n_batches 1 --save_images false
"""

from __future__ import annotations

import argparse

from .common import str2bool


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the CLI on ``argv`` (default ``sys.argv``); returns each batch's
    {"piece_acc", "puzzle_acc"}."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run_dir", type=str, required=True, help="training run dir with checkpoints/")
    ap.add_argument("--checkpoint_path", type=str, default="",
                    help="explicit checkpoint to load (run dir / checkpoints root / step dir) "
                         "instead of run_dir's latest")
    ap.add_argument("--dataset", type=str, default="synthetic")
    ap.add_argument("--puzzle_sizes", nargs="+", default=[6], type=int)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--n_batches", type=int, default=2)
    ap.add_argument("--inference_ratio", type=int, default=None)
    ap.add_argument("--noise_weight", type=float, default=None)
    ap.add_argument("--save_images", type=str2bool, default=True)
    ap.add_argument("--out_dir", type=str, default="")
    ap.add_argument("--calibrate_norm", type=int, default=0,
                    help="pool OrientationNorm stats over N train batches for batch-independent "
                         "inference; saves <run_dir>/norm_stats.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; the CPU runs only when asked for (--device cpu)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..data import PuzzleBatch, collate_puzzles
    from ..data.datasets import get_dataset
    from ..models.diffusion_2d import Diffusion2D, Diffusion2DConfig
    from ..nn.visual import save_norm_stats
    from ..train.checkpoint import CheckpointManager, load_config_near, restore_explicit
    from ..train.train_state import create_train_state, eval_params
    from ..utils.viz import save_trajectory

    if args.checkpoint_path:
        ckpt = None
        cfg_dict = load_config_near(args.checkpoint_path)
    else:
        ckpt = CheckpointManager(f"{args.run_dir}/checkpoints")
        cfg_dict = ckpt.load_config()
    # the sampler's overrides (reference viz_script.py:74-77)
    if args.inference_ratio is not None:
        cfg_dict["inference_ratio"] = args.inference_ratio
    if args.noise_weight is not None:
        cfg_dict["noise_weight"] = args.noise_weight
    model = Diffusion2D(Diffusion2DConfig(**cfg_dict), device=args.device, seed=args.seed)
    cfg = model.cfg

    train_ds, test_ds, _ = get_dataset(args.dataset, puzzle_sizes=list(args.puzzle_sizes), rotation=cfg.rotation,
                                       seed=args.seed)
    model.init(args.seed)
    # a template without EMA: restoring fills the model's own parameters with the live params and puts a
    # saved EMA beside them
    state = create_train_state(model, model.make_optimizer(), torch.Generator(device=model.device))
    if args.checkpoint_path:
        restored = restore_explicit(args.checkpoint_path, state)
        params = eval_params(restored)
        print(f"restored step {restored.step} from {args.checkpoint_path}")
    else:
        restored = ckpt.restore(state)
        params = state.params
        if restored is not None:
            params = eval_params(restored)
            print(f"restored step {restored.step}")
        else:
            print("WARNING: no checkpoint found, using random init")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    model.eval()

    if args.calibrate_norm > 0:
        def patch_batches():
            for bi in range(args.calibrate_norm):
                idxs = range(bi * args.batch_size, (bi + 1) * args.batch_size)
                nb = collate_puzzles([train_ds[i % len(train_ds)] for i in idxs], train_ds.max_nodes)
                p = nb.patches.astype(np.float32) / 255.0
                yield p.reshape(-1, *p.shape[2:])

        stats = model.calibrate_norm_stats(patch_batches())
        if stats:
            save_norm_stats(f"{args.run_dir}/norm_stats.npz", stats)
            print(f"calibrated norm stats over {args.calibrate_norm} batches")
        else:
            print("encoder has no OrientationNorm layers — calibration skipped")

    out_dir = args.out_dir or f"{args.run_dir}/preds"
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    results = []
    for bi in range(args.n_batches):
        idxs = range(bi * args.batch_size, min((bi + 1) * args.batch_size, len(test_ds)))
        nb = collate_puzzles([test_ds[i] for i in idxs], test_ds.max_nodes)
        batch = PuzzleBatch(*nb).to(model.device)
        res = model.sample(batch, gen, keep_trajectory=True)
        m = model.metrics_from_final(res.final, batch)
        results.append({"piece_acc": float(m["piece_acc"].mean()), "puzzle_acc": float(m["puzzle_correct"].mean())})
        print(f"batch {bi}: piece_acc={results[-1]['piece_acc']:.4f} puzzle_acc={results[-1]['puzzle_acc']:.4f}",
              flush=True)
        if args.save_images:
            traj = res.trajectory.cpu().numpy()  # (S, B, N, C)
            for j in range(traj.shape[1]):
                nv = int(nb.node_mask[j].sum())
                save_trajectory(out_dir, np.asarray(nb.patches[j])[:nv], traj[:, j, :nv], np.asarray(nb.x0[j, :nv, :2]),
                                tuple(np.asarray(nb.patches_dim[j])), name=f"b{bi}_s{j}")
    return results


if __name__ == "__main__":
    main()
