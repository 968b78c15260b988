"""Brute-force kNN and bidirectional Chamfer distance — port of the JAX
package's ``ops/knn.py`` (forward only; the Chamfer backward comes with 3D
training, ROADMAP Queue 1 item 17).

The squared distances keep the JAX form |a|² − 2a·bᵀ + |b|², clamped at 0.
The inner product is a plain matmul in full f32 (TF32 off), as the JAX
package computes it in XLA at ``Precision.HIGHEST``. In bf16 the JAX package
rounds at every step: each product a·a to bf16, their f32 sum to bf16, the
f32 inner product to bf16, then each of the two additions to bf16; the port
rounds at the same places, so that kNN on bf16 features sees the same
distances and the same ties. ``knn_indices`` breaks ties by the lower index,
as ``lax.top_k`` does (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

import torch

from .so3 import f32_matmuls


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (..., N, C) × (..., M, C) → (..., N, M),
    in the inputs' type."""
    dt = a.dtype
    a2 = (a * a).float().sum(-1, keepdim=True).to(dt)  # (..., N, 1)
    b2 = (b * b).float().sum(-1, keepdim=True).to(dt)  # (..., M, 1)
    with f32_matmuls():
        inner = torch.matmul(a.float(), b.float().transpose(-1, -2)).to(dt)
    d = a2 - 2.0 * inner + b2.transpose(-1, -2)
    return torch.clamp(d, min=0.0)


def knn_indices(points: torch.Tensor, k: int) -> torch.Tensor:
    """k nearest neighbours within one point set (..., N, C) → (..., N, k),
    the point itself included, nearest first, ties to the lower index."""
    d = pairwise_sqdist(points, points)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def nearest_neighbor(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For each point of a, squared distance to and index of its nearest point
    of b: (..., N, C), (..., M, C) → ((..., N), (..., N))."""
    dist, idx = pairwise_sqdist(a, b).min(dim=-1)
    return dist, idx


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional squared Chamfer terms: (..., N, 3), (..., M, 3) →
    (dist_a (..., N), dist_b (..., M)), each point's squared distance to the
    nearest point of the other cloud; callers mean-reduce. The (N, M) matrix
    is built whole: the evaluation's clouds are per part (512 points)."""
    d = pairwise_sqdist(a, b)
    return d.min(dim=-1).values, d.min(dim=-2).values
