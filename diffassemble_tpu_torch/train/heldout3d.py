"""The held-out evaluation of a trained 3D model — port of the JAX package's
``scripts/tpu_eval_3d.py``.

The synthetic corpus is built with the protocol's arguments
(``protocol_dataset``), collated in batches in order with one
``default_rng(seed)`` (the same draws as the script's), each batch sampled
once per inference ratio, and every valid part scored by its Chamfer
distance under the sampled and the true pose. A row has the script's keys:
ratio, reverse_steps, n_parts, rmse_t and rmse_r (means over objects), gd_r
(mean over parts), part_acc at each threshold (the share of parts with CD
below it), the CD percentiles, and two more blocks:

- ``gauge_aligned``, a diagnostic: each object's poses moved by the one
  global SE(3) that best aligns them with the true ones (a weighted
  Procrustes, R0 = proj_SO(3)(Σ_i R_i^gt R_iᵀ) through a 3×3 SVD with the
  determinant fix, t0 from the weighted means), then gd_r, rmse_t, part_acc
  and the median CD re-measured;
- ``refined``, when the protocol asks for ``refine_steps`` > 0: the sampled
  poses refined by multiview ICP (``models/refine3d.py``), on the
  fracture-wall points alone (``point_w``, the corpus's wall flags), then
  gd_r, rmse_t, rmse_r, part_acc and the median CD.

``calibration`` gives the metric's own scale: part_acc and the median CD of
the true poses under known rotation and translation noise (the zero-noise
row must give part_acc 1.0 at every threshold).

    python -m diffassemble_tpu_torch.train.heldout3d --asset diffusion3d_wallsurf [--compute_dtype float32] \\
        [--device cpu]

runs a committed trained checkpoint (``ASSETS``: the params of the JAX
package's ``weights/diffusion3d_*`` at one step, its config and its
protocol's arguments) over its protocol and prints the result as one JSON
line.
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
from ..models.refine3d import refine_poses
from ..ops import so3
from ..ops.so3 import f32_matmuls

_ASSET_DIR = Path(__file__).resolve().parents[1] / "assets"
# the committed trained checkpoints, by the name of their directory under the JAX package's weights/
ASSETS = {
    "diffusion3d_easy": _ASSET_DIR / "diffusion3d_easy12000.npz",
    "diffusion3d_relpose": _ASSET_DIR / "diffusion3d_relpose12000.npz",
    "diffusion3d_wallsurf": _ASSET_DIR / "diffusion3d_wallsurf18000.npz",
    "diffusion3d_vndgcnn": _ASSET_DIR / "diffusion3d_vndgcnn3000.npz",
}
ASSET = ASSETS["diffusion3d_easy"]
THRESHOLDS = (0.01, 0.02, 0.05, 0.1, 0.2)
PERCENTILES = (5, 10, 25, 50, 75, 90)
# (rotation noise in degrees, translation noise σ) of the calibration rows
CALIBRATION_NOISE = ((0.0, 0.0), (2.0, 0.0), (5.0, 0.0), (10.0, 0.0), (30.0, 0.0), (0.0, 0.01), (0.0, 0.05),
                     (5.0, 0.02))
# the script's defaults where a protocol leaves an argument out
_DEFAULTS = dict(wall_surface=False, wall_freq=14.0, refine_steps=0, refine_anchor=0.05, refine_sigma0=0.2,
                 refine_trim=0.25)


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


def batches(test_ds, batch: int, max_num_part: int, seed: int, device):
    """(collated batch on ``device``, its fracture-wall point weights (B, P,
    N) f32 or None when no point is on a wall) for each call, as the script
    collates them."""
    rng = np.random.default_rng(seed)
    for lo in range(0, len(test_ds), batch):
        samples = [test_ds[i] for i in range(lo, min(lo + batch, len(test_ds)))]
        nb = collate_fragments(samples, max_num_part, rng=rng)
        # wall membership comes from the surface segmentation, not from the true poses
        pw = np.zeros(nb.pcds.shape[:3], np.float32)
        for i, smp in enumerate(samples):
            if "wall" in smp:
                pw[i, : min(smp["n_parts"], max_num_part)] = smp["wall"][:max_num_part].astype(np.float32)
        yield nb.to(device), (torch.as_tensor(pw, device=device) if pw.any() else None)


def gauge_align(pred_q, pred_t, gt_q, gt_t, valid):
    """Each object's poses moved by the one global SE(3) that best aligns
    them with the true ones: (aligned rotations (B, P, 3, 3), aligned
    translations (B, P, 3))."""
    with f32_matmuls():
        pred_r, gt_r = so3.quaternion_to_matrix(pred_q), so3.quaternion_to_matrix(gt_q)
        w = valid.to(pred_r.dtype)
        m = torch.einsum("bp,bpij,bpkj->bik", w, gt_r, pred_r)
        u, _, vt = torch.linalg.svd(m)
        det = torch.linalg.det(u @ vt)
        d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
        r0 = torch.einsum("bij,bj,bjk->bik", u, d, vt)
        nv = w.sum(1, keepdim=True) + 1e-9
        mean_gt = (gt_t * w[..., None]).sum(1) / nv
        mean_pr = (pred_t * w[..., None]).sum(1) / nv
        t0 = mean_gt - torch.einsum("bij,bj->bi", r0, mean_pr)
        a_t = torch.einsum("bij,bpj->bpi", r0, pred_t) + t0[:, None]
        a_r = torch.einsum("bij,bpjk->bpik", r0, pred_r)
    return a_r, a_t


def _acc(cd: np.ndarray) -> dict[str, float]:
    return {str(t): float((cd < t).mean()) for t in THRESHOLDS}


def _mean64(xs) -> float:
    return float(np.mean(np.concatenate(xs).astype(np.float64)))


@torch.no_grad()
def heldout3d_eval(model, test_ds, batch: int = 16, max_num_part: int = 20, seed: int = 0,
                   ratio: int | None = None, refine: dict | None = None) -> dict:
    """The script's row of ``model`` (a ``Diffusion3D``) over ``test_ds``,
    sampled at the inference ``ratio`` (default: the config's), refined with
    ``refine_poses``'s keyword arguments ``refine`` when given. The
    sampler's initial noise comes from torch's default generator; the model
    scales it by its ``noise_weight`` (0 in the trained configs) and runs
    DDIM without eta, as the script's fixed key changes nothing there."""
    keys = ("cd", "gd", "rt", "rr", "cd_a", "gd_a", "rt_a", "cd_f", "gd_f", "rt_f", "rr_f")
    acc = {k: [] for k in keys}
    for nb, point_w in batches(test_ds, batch, max_num_part, seed, model.device):
        final = model.sample(nb, inference_ratio=ratio).final
        pred_q, pred_t = final[..., :4], final[..., 4:7]
        gt_q, gt_t = nb.x0[..., :4], nb.x0[..., 4:7]
        v = nb.node_mask
        gt_r = so3.quaternion_to_matrix(gt_q)
        a_r, a_t = gauge_align(pred_q, pred_t, gt_q, gt_t, v)
        scored = [("", pred_q, pred_t), ("_a", so3.matrix_to_quaternion(a_r), a_t)]
        if refine:
            res = refine_poses(nb.pcds, v, pred_q, pred_t, point_w=point_w, **refine)
            scored.append(("_f", res.quat, res.trans))
        for tag, q, t in scored:
            cd = losses_3d.per_part_cd(nb.pcds, t, gt_t, q, gt_q)
            gd = so3.geodesic_distance_rmat(a_r if tag == "_a" else so3.quaternion_to_matrix(q), gt_r)
            acc["cd" + tag].append(cd[v].cpu().numpy())
            acc["gd" + tag].append(gd[v].cpu().numpy())
            acc["rt" + tag].append(losses_3d.trans_rmse(t, gt_t, v).cpu().numpy())
            if tag != "_a":
                acc["rr" + tag].append(losses_3d.rot_euler_rmse(q, gt_q, v).cpu().numpy())
    cd, gd = np.concatenate(acc["cd"]), np.concatenate(acc["gd"])
    cd_a = np.concatenate(acc["cd_a"])
    ratio_ = ratio or model.cfg.inference_ratio
    row = {
        "ratio": ratio_,
        "reverse_steps": model.cfg.steps // ratio_,
        "n_parts": int(cd.size),
        "rmse_t": _mean64(acc["rt"]),
        "rmse_r": _mean64(acc["rr"]),
        "gd_r": float(gd.mean()),
        "part_acc": _acc(cd),
        "cd_percentiles": {str(p): float(np.percentile(cd, p)) for p in PERCENTILES},
        # a diagnostic, not the parity metric: what is left once each object's global frame is removed
        "gauge_aligned": {"gd_r": float(np.concatenate(acc["gd_a"]).mean()), "rmse_t": _mean64(acc["rt_a"]),
                          "part_acc": _acc(cd_a), "cd_median": float(np.median(cd_a))},
    }
    if refine:
        cd_f = np.concatenate(acc["cd_f"])
        row["refined"] = {"steps": refine["steps"], "gd_r": float(np.concatenate(acc["gd_f"]).mean()),
                          "rmse_t": _mean64(acc["rt_f"]), "rmse_r": _mean64(acc["rr_f"]), "part_acc": _acc(cd_f),
                          "cd_median": float(np.median(cd_f))}
    return row


@torch.no_grad()
def calibration(test_ds, batch: int = 16, max_num_part: int = 20, seed: int = 0,
                device: torch.device | str = "cpu") -> list[dict]:
    """part_acc and the median CD of the true poses under known noise (each
    of ``CALIBRATION_NOISE``): each part's rotation turned by the given angle
    about a random axis, its translation moved by N(0, σ²); the draws of
    call i come from a ``torch.Generator`` seeded 100 + i."""
    calls = list(batches(test_ds, batch, max_num_part, seed, device))
    rows = []
    for rot_deg, trans_sigma in CALIBRATION_NOISE:
        cds = []
        for i, (nb, _) in enumerate(calls):
            gen = torch.Generator(device=nb.x0.device).manual_seed(100 + i)
            gt_q, gt_t = nb.x0[..., :4], nb.x0[..., 4:7]
            axis = torch.randn(gt_t.shape, generator=gen, device=gt_t.device)
            axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + 1e-9)
            dr = so3.rotvec_to_rmat(axis * np.deg2rad(rot_deg))
            pred_q = so3.matrix_to_quaternion(so3._mm(dr, so3.quaternion_to_matrix(gt_q)))
            pred_t = gt_t + trans_sigma * torch.randn(gt_t.shape, generator=gen, device=gt_t.device)
            cds.append(losses_3d.per_part_cd(nb.pcds, pred_t, gt_t, pred_q, gt_q)[nb.node_mask].cpu().numpy())
        cd = np.concatenate(cds)
        rows.append({"rot_deg": rot_deg, "trans_sigma": trans_sigma, "part_acc": _acc(cd),
                     "cd_median": float(np.median(cd))})
    return rows


def model_from_asset(path=ASSET, device: torch.device | str = "cuda", compute_dtype: str | None = None):
    """(model with the asset's weights, its config, the protocol's arguments,
    the checkpoint's step) of an asset path or a name of ``ASSETS``;
    ``compute_dtype`` overrides the config's."""
    state, extras = convert.load_jax_npz(ASSETS.get(str(path), path), convert.HEADS_3D)
    cfg = Diffusion3DConfig(**json.loads(str(extras["config"])))
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = Diffusion3D(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model, cfg, json.loads(str(extras["protocol"])), int(extras["step"])


def protocol_ratios(protocol: dict) -> list[int | None]:
    """The protocol's inference ratios: its ``ratios``, else its ``ratio``,
    else the config's (None)."""
    if "ratios" in protocol:
        return list(protocol["ratios"])
    return [protocol.get("ratio")]


def protocol_corpus(protocol: dict, test_n: int | None = None):
    """The protocol's corpus (its first ``test_n`` objects); ``wall_surface``
    and ``wall_freq`` default to the script's (0 and 14.0) where the
    protocol leaves them out."""
    p = {**_DEFAULTS, **protocol}
    return protocol_dataset(test_n=test_n or p["test_n"], num_points=p["num_points"],
                            max_num_part=p["max_num_part"], min_num_part=p["min_num_part"],
                            wall_detail=p["wall_detail"], wall_boost=p["wall_boost"], canonical=p["canonical"],
                            seed=p["seed"], wall_surface=p["wall_surface"], wall_freq=p["wall_freq"])


def refine_args(protocol: dict) -> dict | None:
    """``refine_poses``'s keyword arguments of the protocol, or None when it
    does not refine."""
    p = {**_DEFAULTS, **protocol}
    if p["refine_steps"] <= 0:
        return None
    return dict(steps=p["refine_steps"], anchor=p["refine_anchor"], sigma0=p["refine_sigma0"], trim=p["refine_trim"])


def run_protocol(model, protocol: dict, test_n: int | None = None, ratio: int | None = None) -> dict:
    """``heldout3d_eval`` over the protocol's corpus at ``ratio`` (default:
    the protocol's first), with its refinement."""
    ratio = protocol_ratios(protocol)[0] if ratio is None else ratio
    return heldout3d_eval(model, protocol_corpus(protocol, test_n), batch=protocol["batch"],
                          max_num_part=protocol["max_num_part"], seed=protocol["seed"], ratio=ratio,
                          refine=refine_args(protocol))


def main() -> None:
    ap = argparse.ArgumentParser(description="The held-out 3D protocol on a committed trained checkpoint.")
    ap.add_argument("--asset", default="diffusion3d_easy", help=f"one of {sorted(ASSETS)}, or an asset's path")
    ap.add_argument("--ratios", type=int, nargs="+", default=None, help="default: the protocol's")
    ap.add_argument("--compute_dtype", default=None, help="default: the checkpoint's config (bfloat16)")
    ap.add_argument("--test_n", type=int, default=None, help="default: the protocol's 64 objects")
    ap.add_argument("--device", default="cuda", help="torch device; the CPU runs only when asked for")
    args = ap.parse_args()
    model, cfg, protocol, step = model_from_asset(args.asset, args.device, args.compute_dtype)
    test_ds = protocol_corpus(protocol, args.test_n)
    calib = calibration(test_ds, protocol["batch"], protocol["max_num_part"], protocol["seed"], model.device)
    rows = [run_protocol(model, protocol, args.test_n, ratio) for ratio in (args.ratios or protocol_ratios(protocol))]
    print(json.dumps({"asset": str(args.asset), "step": step, "compute_dtype": cfg.compute_dtype,
                      "device": str(model.device), "calibration": calib, "rows": rows}))


if __name__ == "__main__":
    main()
