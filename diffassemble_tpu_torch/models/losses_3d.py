"""3D reassembly metrics over padded (B, P, …) part arrays — port of the
metrics half of the JAX package's ``models/losses_3d.py`` (the reference's
trans_metrics, rot_metrics with its 360° wrap, geodesic_distance and
calc_part_acc). The losses come with 3D training (ROADMAP Queue 1 item 17).

Rotations of point clouds are full-f32 products (TF32 off), as the JAX
package computes them in f32.
"""

from __future__ import annotations

import torch

from ..ops.knn import chamfer_distance
from ..ops.so3 import f32_matmuls, geodesic_distance_rmat, quaternion_to_euler, quaternion_to_matrix


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
