"""Brute-force kNN and bidirectional Chamfer distance — port of the JAX
package's ``ops/knn.py``, the Chamfer distance with its backward through the
argmin neighbours (``_Chamfer``, the JAX ``custom_vjp``).

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


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, chunk: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional squared Chamfer terms: (..., N, 3), (..., M, 3) →
    (dist_a (..., N), dist_b (..., M)), each point's squared distance to the
    nearest point of the other cloud; callers mean-reduce.

    ``chunk=None`` builds the (N, M) matrix whole up to 2M pairs and above
    that scans the rows of ``a`` in chunks of 2048 with a running minimum over
    the columns, as the JAX package does: the shape-level Chamfer of a train
    batch (16 objects of 8 × 512 points) is a 1.07 GB f32 matrix whole, and
    Breaking-Bad's 20 × 1000 points would be 25.6 GB at batch 16, while a
    chunk holds 2048 rows. The result is the same either way (ties go to the
    lower index in both).

    The gradient runs through the argmin neighbours only (∂|aᵢ − b_{j*}|²),
    as the JAX package's custom VJP does: the backward keeps the two index
    vectors, never a distance matrix."""
    return _Chamfer.apply(a, b, 0 if chunk is None else chunk)


def _chamfer_with_idx(a: torch.Tensor, b: torch.Tensor, chunk: int):
    """(d_a, d_b, i_a, i_b): the two minima and their argmins, ties to the
    lower index (``torch.min`` returns the first minimum, as ``jnp.argmin``)."""
    n, m = a.shape[-2], b.shape[-2]
    if chunk == 0:
        chunk = 0 if n * m <= 2_000_000 else 2048
    if chunk == 0 or n <= chunk:
        d = pairwise_sqdist(a, b)
        d_a, i_a = d.min(dim=-1)
        d_b, i_b = d.min(dim=-2)
        return d_a, d_b, i_a, i_b
    d_as, i_as = [], []
    d_b = i_b = None
    for start in range(0, n, chunk):
        d = pairwise_sqdist(a[..., start:start + chunk, :], b)  # (..., chunk, M)
        d_a, i_a = d.min(dim=-1)
        d_as.append(d_a)
        i_as.append(i_a)
        d_col, i_col = d.min(dim=-2)
        i_col = i_col + start  # the global row
        if d_b is None:
            d_b, i_b = d_col, i_col
        else:  # strictly better only: an earlier chunk keeps a tie
            better = d_col < d_b
            d_b, i_b = torch.where(better, d_col, d_b), torch.where(better, i_col, i_b)
    return torch.cat(d_as, dim=-1), d_b, torch.cat(i_as, dim=-1), i_b


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., M, C) at rows idx (..., N) → (..., N, C)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _scatter_add_rows(m: int, idx: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """Scatter-add ``updates`` (..., N, C) into zeros (..., M, C) at rows ``idx`` (..., N)."""
    out = updates.new_zeros((*updates.shape[:-2], m, updates.shape[-1]))
    return out.scatter_add_(-2, idx[..., None].expand(updates.shape), updates)


class _Chamfer(torch.autograd.Function):
    """The forward keeps the inputs and the argmin index vectors; the
    backward is d_aᵢ = |aᵢ − b_{j*}|² differentiated: 2·g·(aᵢ − b_{j*}) on aᵢ
    and its negative scattered onto b_{j*}, for both directions."""

    @staticmethod
    def forward(ctx, a, b, chunk):
        d_a, d_b, i_a, i_b = _chamfer_with_idx(a, b, chunk)
        ctx.save_for_backward(a, b, i_a, i_b)
        return d_a, d_b

    @staticmethod
    def backward(ctx, g_a, g_b):
        a, b, i_a, i_b = ctx.saved_tensors
        w_a = 2.0 * g_a[..., None] * (a - _take_rows(b, i_a))
        w_b = 2.0 * g_b[..., None] * (b - _take_rows(a, i_b))
        da = w_a + _scatter_add_rows(a.shape[-2], i_b, -w_b)
        db = w_b + _scatter_add_rows(b.shape[-2], i_a, -w_a)
        return da, db, None
