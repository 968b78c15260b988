"""The held-out evaluation of a trained 3D model — the core of the JAX
package's ``scripts/tpu_eval_3d.py``, without its gauge-aligned diagnostic
and its refinement stage.

The synthetic corpus is built with the script's arguments (``protocol_dataset``),
collated in batches in order with one ``default_rng(seed)`` (the same draws
as the script's), each batch sampled once, and every valid part scored by its
Chamfer distance under the sampled and the true pose. The result has the
script's keys: n_parts, rmse_t and rmse_r (means over objects), gd_r (mean
over parts), part_acc at each threshold (the share of parts with CD below
it) and the CD percentiles.

    python -m diffassemble_tpu_torch.train.heldout3d [--compute_dtype float32] [--device cpu]

runs the committed trained checkpoint (``assets/diffusion3d_easy12000.npz``:
the params of the JAX package's ``weights/diffusion3d_easy`` at step 12000,
its config and the protocol's arguments) over the protocol and prints the
result as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from .. import convert
from ..data.breaking_bad import collate_fragments, get_dataset_3d
from ..models import Diffusion3D, Diffusion3DConfig, losses_3d
from ..ops import so3

ASSET = Path(__file__).resolve().parents[1] / "assets" / "diffusion3d_easy12000.npz"
THRESHOLDS = (0.01, 0.02, 0.05, 0.1, 0.2)
PERCENTILES = (5, 10, 25, 50, 75, 90)


def protocol_dataset(test_n: int = 64, num_points: int = 1000, max_num_part: int = 20, min_num_part: int = 2,
                     wall_detail: float = 0.0, wall_boost: int = 1, canonical: float = 0.6, seed: int = 0,
                     wall_surface: bool = False, wall_freq: float = 14.0):
    """The script's held-out split: ``get_dataset_3d("synthetic", ...)``'s test
    set (Voronoi parts) with the script's arguments and defaults."""
    _, test_ds, _ = get_dataset_3d(
        "synthetic", train_n=4, test_n=test_n, max_num_part=max_num_part, min_num_part=min_num_part,
        num_points=num_points, seed=seed, canonical=canonical, voronoi=True, wall_detail=wall_detail,
        wall_boost=wall_boost, wall_surface=bool(wall_surface), wall_freq=wall_freq)
    return test_ds


@torch.no_grad()
def heldout3d_eval(model, test_ds, batch: int = 16, max_num_part: int = 20, seed: int = 0,
                   ratio: int | None = None) -> dict:
    """The script's metrics of ``model`` (a ``Diffusion3D``) over ``test_ds``,
    sampled at the inference ``ratio`` (default: the config's). The
    sampler's initial noise comes from torch's default generator; the model
    scales it by its ``noise_weight`` (0 in the trained configs) and runs
    DDIM without eta, as the script's fixed key changes nothing there."""
    rng = np.random.default_rng(seed)
    cds, gds, rts, rrs = [], [], [], []
    for lo in range(0, len(test_ds), batch):
        samples = [test_ds[i] for i in range(lo, min(lo + batch, len(test_ds)))]
        nb = collate_fragments(samples, max_num_part, rng=rng).to(model.device)
        final = model.sample(nb, inference_ratio=ratio).final
        pred_q, pred_t = final[..., :4], final[..., 4:7]
        gt_q, gt_t = nb.x0[..., :4], nb.x0[..., 4:7]
        v = nb.node_mask
        cd = losses_3d.per_part_cd(nb.pcds, pred_t, gt_t, pred_q, gt_q)
        gd = so3.geodesic_distance_rmat(so3.quaternion_to_matrix(pred_q), so3.quaternion_to_matrix(gt_q))
        cds.append(cd[v].cpu().numpy())
        gds.append(gd[v].cpu().numpy())
        rts.append(losses_3d.trans_rmse(pred_t, gt_t, v).cpu().numpy())
        rrs.append(losses_3d.rot_euler_rmse(pred_q, gt_q, v).cpu().numpy())
    cd, gd = np.concatenate(cds), np.concatenate(gds)
    return {
        "n_parts": int(cd.size),
        "rmse_t": float(np.mean(np.concatenate(rts).astype(np.float64))),
        "rmse_r": float(np.mean(np.concatenate(rrs).astype(np.float64))),
        "gd_r": float(gd.mean()),
        "part_acc": {str(t): float((cd < t).mean()) for t in THRESHOLDS},
        "cd_percentiles": {str(p): float(np.percentile(cd, p)) for p in PERCENTILES},
    }


def model_from_asset(path=ASSET, device: torch.device | str = "cuda", compute_dtype: str | None = None):
    """(model with the asset's weights, its config, the protocol's arguments,
    the checkpoint's step); ``compute_dtype`` overrides the config's."""
    state, extras = convert.load_jax_npz(path, convert.HEADS_3D)
    cfg = Diffusion3DConfig(**json.loads(str(extras["config"])))
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = Diffusion3D(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model, cfg, json.loads(str(extras["protocol"])), int(extras["step"])


def run_protocol(model, protocol: dict, test_n: int | None = None) -> dict:
    """``heldout3d_eval`` over the protocol's corpus (its first ``test_n``
    objects) at the protocol's ratio; ``wall_surface`` and ``wall_freq``
    default to the script's (0 and 14.0) where the protocol leaves them out."""
    p = protocol
    test_ds = protocol_dataset(test_n=test_n or p["test_n"], num_points=p["num_points"],
                               max_num_part=p["max_num_part"], min_num_part=p["min_num_part"],
                               wall_detail=p["wall_detail"], wall_boost=p["wall_boost"],
                               canonical=p["canonical"], seed=p["seed"],
                               wall_surface=p.get("wall_surface", False), wall_freq=p.get("wall_freq", 14.0))
    return heldout3d_eval(model, test_ds, batch=p["batch"], max_num_part=p["max_num_part"], seed=p["seed"],
                          ratio=p.get("ratio"))


def main() -> None:
    ap = argparse.ArgumentParser(description="The held-out 3D protocol on the committed trained checkpoint.")
    ap.add_argument("--asset", default=str(ASSET))
    ap.add_argument("--compute_dtype", default=None, help="default: the checkpoint's config (bfloat16)")
    ap.add_argument("--test_n", type=int, default=None, help="default: the protocol's 64 objects")
    ap.add_argument("--device", default="cuda", help="torch device; the CPU runs only when asked for")
    args = ap.parse_args()
    model, cfg, protocol, step = model_from_asset(args.asset, args.device, args.compute_dtype)
    result = run_protocol(model, protocol, args.test_n)
    print(json.dumps({"step": step, "compute_dtype": cfg.compute_dtype, "device": str(model.device), **result}))


if __name__ == "__main__":
    main()
