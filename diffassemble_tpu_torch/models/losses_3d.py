"""3D reassembly losses and metrics over padded (B, P, …) part arrays — port
of the JAX package's ``models/losses_3d.py``: the reference's five-term loss
dict (translation L2, quaternion cosine, per-point L2 and Chamfer of the
rotated clouds, the shape-level Chamfer with invalid parts filled with 1e3
and divided by the fixed P·N), its metrics (trans_metrics, rot_metrics with
its 360° wrap, geodesic_distance, calc_part_acc), and the relative-pose
supervision (contact matrix, relative targets, their losses).

Every f32 product (clouds rotated, the contact distances, the relative
targets) runs in full f32 (TF32 off, ``so3.f32_matmuls``), as the JAX package
computes them in f32.
"""

from __future__ import annotations

import torch

from ..ops.knn import chamfer_distance
from ..ops.so3 import f32_matmuls, geodesic_distance_rmat, quaternion_to_euler, quaternion_to_matrix

_PAD_FILL = 1e3


def _valid_mean(x: torch.Tensor, valids: torch.Tensor) -> torch.Tensor:
    """Masked mean over the part axis: (B, P), (B, P) → (B,)."""
    v = valids.to(x.dtype)
    return (x * v).sum(-1) / torch.clamp(v.sum(-1), min=1.0)


def rotate_pc(quat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply per-part rotations: quat (B, P, 4), pts (B, P, N, 3)."""
    with f32_matmuls():
        return torch.einsum("bpij,bpnj->bpni", quaternion_to_matrix(quat), pts)


def transform_pc(trans: torch.Tensor, quat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return rotate_pc(quat, pts) + trans[:, :, None, :]


# ------------------------------------------------------------------- losses


def trans_l2_loss(t1, t2, valids):
    """Σ(Δt)² per part, masked mean over parts: (B,)."""
    return _valid_mean(((t1 - t2) ** 2).sum(-1), valids)


def rot_cosine_loss(q1, q2, valids):
    """1 − |⟨q1, q2⟩| per part, masked mean: (B,)."""
    return _valid_mean(1.0 - (q1 * q2).sum(-1).abs(), valids)


def rot_l2_loss(q1, q2, valids):
    """min(|q1 − q2|², |q1 + q2|²) (the ±q ambiguity), masked mean: (B,)."""
    d1 = ((q1 - q2) ** 2).sum(-1)
    d2 = ((q1 + q2) ** 2).sum(-1)
    return _valid_mean(torch.minimum(d1, d2), valids)


def rot_points_l2_loss(pts, q1, q2, valids):
    """Per-point L2 between the clouds rotated by q1 and by q2: (B,)."""
    per_part = ((rotate_pc(q1, pts) - rotate_pc(q2, pts)) ** 2).sum(-1).mean(-1)
    return _valid_mean(per_part, valids)


def rot_points_cd_loss(pts, q1, q2, valids):
    """Per-part Chamfer between the rotated clouds: (B,)."""
    d1, d2 = chamfer_distance(rotate_pc(q1, pts), rotate_pc(q2, pts))  # (B, P, N) each
    return _valid_mean(d1.mean(-1) + d2.mean(-1), valids)


def shape_cd_loss(pts, t1, t2, q1, q2, valids):
    """Shape-level Chamfer after the full transforms: (B,). Invalid parts are
    filled with 1e3 so that they never match, and the sum over matched
    distances is divided by the fixed P·N (the reference's hard-negative
    weighting: shapes with more parts incur more loss)."""
    b, p, n, _ = pts.shape
    fill = torch.where(valids[..., None, None], 0.0, _PAD_FILL)
    s1 = (transform_pc(t1, q1, pts) + fill).reshape(b, p * n, 3)
    s2 = (transform_pc(t2, q2, pts) + fill).reshape(b, p * n, 3)
    d1, d2 = chamfer_distance(s1, s2)  # (B, P·N)
    vmask = valids.to(d1.dtype).repeat_interleave(n, dim=-1)
    return (d1 * vmask).mean(-1) + (d2 * vmask).mean(-1)


# the reference's weights (…double_diffusion.py:472-479)
DEFAULT_LOSS_WEIGHTS = {
    "trans_loss": 1.0,
    "rot_pt_cd_loss": 0.0,
    "transform_pt_cd_loss": 10.0,
    "rot_loss": 0.2,
    "rot_pt_l2_loss": 0.0,
}


def reassembly_loss_dict(pts, pred_t, gt_t, pred_q, gt_q, valids) -> dict:
    """The five terms of the reference's p_losses, batch-meaned; the caller
    weights them (``DEFAULT_LOSS_WEIGHTS``). Each is a mean over objects of a
    per-object value, so under data-parallel training with equal slices per
    rank the ranks' mean, which DDP takes, is the whole batch's as it is."""
    return {
        "trans_loss": trans_l2_loss(pred_t, gt_t, valids).mean(),
        "rot_pt_cd_loss": rot_points_cd_loss(pts, pred_q, gt_q, valids).mean(),
        "transform_pt_cd_loss": shape_cd_loss(pts, pred_t, gt_t, pred_q, gt_q, valids).mean(),
        "rot_loss": rot_cosine_loss(pred_q, gt_q, valids).mean(),
        "rot_pt_l2_loss": rot_points_l2_loss(pts, pred_q, gt_q, valids).mean(),
    }


# ------------------------------------------------------------------ metrics


def trans_rmse(t1, t2, valids):
    """RMSE over coordinates per part, masked mean over parts: (B,)."""
    per_part = torch.sqrt(((t1 - t2) ** 2).mean(-1) + 1e-12)
    return _valid_mean(per_part, valids)


def rot_euler_rmse(q1, q2, valids):
    """Euler-degree RMSE with 360° wraparound: (B,)."""
    diff = (quaternion_to_euler(q1, order="zyx") - quaternion_to_euler(q2, order="zyx")).abs()
    diff = torch.minimum(diff, 360.0 - diff)
    per_part = torch.sqrt((diff**2).mean(-1) + 1e-12)
    return _valid_mean(per_part, valids)


def rot_geodesic(q1, q2, valids):
    """Mean geodesic angle in radians: (B,)."""
    return _valid_mean(geodesic_distance_rmat(quaternion_to_matrix(q1), quaternion_to_matrix(q2)), valids)


def per_part_cd(pts, t1, t2, q1, q2) -> torch.Tensor:
    """Per-part Chamfer distance between the clouds under both poses: (B, P)."""
    d1, d2 = chamfer_distance(transform_pc(t1, q1, pts), transform_pc(t2, q2, pts))
    return d1.mean(-1) + d2.mean(-1)


def part_accuracy(pts, t1, t2, q1, q2, valids):
    """Fraction of parts whose per-part CD < 0.01: (B,)."""
    return _valid_mean((per_part_cd(pts, t1, t2, q1, q2) < 0.01).float(), valids)


# ------------------------------------------------- relative-pose supervision


def contact_matrix(pcds, gt_q, gt_t, valids, thresh: float = 0.1, n_sub: int = 64) -> torch.Tensor:
    """(B, P, P) bool: the pairs of distinct valid parts whose clouds, posed
    by the ground truth, come within ``thresh``. The dataset rotates each
    cloud by Mᵀ, so the canonical cloud is M applied back (the conjugate
    quaternion) plus t; distances use the first ``n_sub`` points (the input
    order is already random)."""
    q_conj = gt_q * torch.tensor([1.0, -1.0, -1.0, -1.0], device=gt_q.device)
    canon = transform_pc(gt_t, q_conj, pcds[:, :, :n_sub])  # (B, P, n, 3)
    sq = (canon * canon).sum(-1)  # (B, P, n)
    with f32_matmuls():
        cross = torch.einsum("bpnc,bqmc->bpqnm", canon, canon)
    d2 = sq[:, :, None, :, None] + sq[:, None, :, None, :] - 2.0 * cross
    d2min = d2.amin(dim=(-2, -1))  # (B, P, P)
    p = pcds.shape[1]
    eye = torch.eye(p, dtype=torch.bool, device=pcds.device)
    pair_valid = valids[:, :, None].bool() & valids[:, None, :].bool()
    return (d2min < thresh * thresh) & pair_valid & ~eye


def relative_pose_targets(gt_q, gt_t):
    """R_ij = M_i M_jᵀ (B, P, P, 3, 3) and o_ij = M_i (t_j − t_i) (B, P, P, 3)."""
    m = quaternion_to_matrix(gt_q)
    d = gt_t[:, None, :, :] - gt_t[:, :, None, :]  # [b, i, j] = t_j − t_i
    with f32_matmuls():
        r_ij = torch.einsum("bpvc,bqwc->bpqvw", m, m)
        o_ij = torch.einsum("bpvc,bpqc->bpqv", m, d)
    return r_ij, o_ij


def relative_pose_loss(rot_raw, offset, conf, gt_q, gt_t, contact, valids, group=None) -> dict:
    """The pairwise head's losses: the raw bilinear rotation's Frobenius
    error and the offset's L2 on contact pairs (each divided by the batch's
    contact count), and the BCE of the contact logit over valid i ≠ j pairs
    (divided by their count). The raw output is supervised, not its SO(3)
    projection: its gradients stay finite everywhere.

    With a process ``group`` (data-parallel training, each rank holding an
    equal slice of the batch) the two counts are the whole batch's, summed
    over the group's ranks, over the group's size: the ranks' mean of these
    losses, which DDP takes, is then the whole batch's, as the JAX package's
    global sums under pjit give it."""
    r_gt, o_gt = relative_pose_targets(gt_q, gt_t)
    c = contact.float()
    p = conf.shape[-1]
    eye = torch.eye(p, dtype=torch.bool, device=conf.device)
    pvf = (valids[:, :, None].bool() & valids[:, None, :].bool() & ~eye).float()
    counts = torch.stack([c.sum(), pvf.sum()])
    world = 1
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(counts, group=group)
        world = dist.get_world_size(group)
    denom, pairs = torch.clamp(counts, min=1.0) / world
    rot_l = (c * ((rot_raw - r_gt) ** 2).mean(dim=(-2, -1))).sum() / denom
    off_l = (c * ((offset - o_gt) ** 2).sum(-1)).sum() / denom
    # BCE with logits, masked to the valid i ≠ j pairs
    bce = torch.clamp(conf, min=0.0) - conf * c + torch.log1p(torch.exp(-conf.abs()))
    conf_l = (pvf * bce).sum() / pairs
    return {"rel_rot_loss": rot_l, "rel_off_loss": off_l, "rel_conf_loss": conf_l}
