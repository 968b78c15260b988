"""PointNet-family point-cloud encoders and the encoder switch — port of the
JAX package's ``nn/pointnet.py``.

- ``PointNet``: a shared per-point MLP stack [64, 64, 64, 128, feat] with
  LayerNorm and ReLU, then a global max-pool → (B, feat); ``use_tnet`` adds
  the learned 3×3 input and 64×64 feature transforms (``TNet``, initialised
  at the identity).
- ``PointNetPlus``: one set-abstraction stage (every ``n // 128``-th point a
  centroid, its 16 nearest input points grouped relative to it, an MLP and a
  max-pool over the group), then a global stage over the centroids.
- ``make_point_encoder``: the backbone table, with the VN encoders of
  ``nn/vn.py``.

The max-pool's gradient goes to one winner per channel (the first maximum),
as the JAX package's gather-based ``max_pool`` routes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.knn import knn_indices
from .layers import Dense, LayerNorm
from .vn import VN_DGCNN, VNPointNetEncoder


def max_pool(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Max over ``dim`` through the first argmax and a gather."""
    idx = x.argmax(dim=dim, keepdim=True)
    return x.gather(dim, idx).squeeze(dim)


class PointMLP(nn.Module):
    """Shared per-point MLP: Dense → LayerNorm (→ ReLU but after the last)."""

    def __init__(self, in_features: int, widths: tuple[int, ...], dtype: torch.dtype = torch.float32):
        super().__init__()
        ins = (in_features, *widths[:-1])
        self.dense = nn.ModuleList(Dense(i, w, dtype=dtype) for i, w in zip(ins, widths))
        self.norms = nn.ModuleList(LayerNorm(w, dtype) for w in widths)

    def forward(self, x):  # (..., N, C)
        last = len(self.dense) - 1
        for i, (dense, norm) in enumerate(zip(self.dense, self.norms)):
            x = norm(dense(x))
            if i < last:
                x = F.relu(x)
        return x


class _ZeroDense(Dense):
    """A Dense layer whose seeded initialisation is zeros (the T-net's last)."""

    def reference_init(self, normal) -> None:
        del normal
        self.weight.zero_()
        self.bias.zero_()


class TNet(nn.Module):
    """Learned k×k alignment transform regressed from global features:
    identity plus a regressed delta."""

    def __init__(self, k: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        self.mlps = nn.ModuleList([PointMLP(k, (64, 128, 1024), dtype)])
        self.dense = nn.ModuleList([Dense(1024, 512, dtype=dtype), Dense(512, 256, dtype=dtype),
                                    _ZeroDense(256, k * k, dtype=dtype)])

    def forward(self, x):  # (B, N, k)
        g = max_pool(self.mlps[0](x))
        g = F.relu(self.dense[0](g))
        g = F.relu(self.dense[1](g))
        eye = torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(1, -1)
        return (self.dense[2](g) + eye).reshape(-1, self.k, self.k)


class PointNet(nn.Module):
    """(B, N, 3) → (B, feat_dim) global features."""

    def __init__(self, feat_dim: int = 128, use_tnet: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.mlps = nn.ModuleList([PointMLP(3, (64, 64), dtype), PointMLP(64, (64, 128, feat_dim), dtype)])
        self.tnets = nn.ModuleList([TNet(3, dtype), TNet(64, dtype)]) if use_tnet else None

    def forward(self, pts):
        x = pts.to(self.compute_dtype)
        if self.tnets is not None:
            x = torch.bmm(x, self.tnets[0](x))
        x = F.relu(self.mlps[0](x))
        if self.tnets is not None:
            x = torch.bmm(x, self.tnets[1](x))
        return max_pool(self.mlps[1](x))


class PointNetPlus(nn.Module):
    """Two-stage set-abstraction encoder → (B, feat_dim)."""

    def __init__(self, feat_dim: int = 256, n_centroids: int = 128, k: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_centroids, self.k, self.compute_dtype = n_centroids, k, dtype
        self.mlps = nn.ModuleList([PointMLP(3, (64, 64, 128), dtype), PointMLP(128 + 3, (128, 256, feat_dim), dtype)])

    def forward(self, pts):  # (B, N, 3)
        b, n, _ = pts.shape
        stride = max(n // self.n_centroids, 1)
        centroids = pts[:, ::stride][:, : self.n_centroids]  # (B, M, 3)
        m = centroids.shape[1]
        both = torch.cat([centroids, pts], dim=1)
        # the k nearest of centroids and points around each centroid (itself included)
        idx = knn_indices(both, self.k)[:, :m]  # (B, M, k)
        grouped = both[torch.arange(b, device=pts.device)[:, None, None], idx]  # (B, M, k, 3)
        rel = grouped - centroids[:, :, None, :]
        local = max_pool(self.mlps[0](rel.to(self.compute_dtype)))  # (B, M, 128)
        h = torch.cat([local, centroids.to(self.compute_dtype)], dim=-1)
        return max_pool(self.mlps[1](h))


def make_point_encoder(name: str, dtype: torch.dtype = torch.float32) -> tuple[nn.Module, int]:
    """(encoder, output dim) for a backbone name, as the JAX package's table has them."""
    table = {
        "pointnet": (lambda: PointNet(feat_dim=128, dtype=dtype), 128),
        "pointnet_inv": (lambda: PointNet(feat_dim=1024, use_tnet=True, dtype=dtype), 1024),
        "pointnet_plus": (lambda: PointNetPlus(feat_dim=256, dtype=dtype), 256),
        "vn_dgcnn": (lambda: VN_DGCNN(feat_dim=128, dtype=dtype), 768),
        "vn_dgcnn_inv": (lambda: VN_DGCNN(feat_dim=128, invariant=True, dtype=dtype), 256),
        # [equiv(768) ‖ inv(256)]: the layout of the relative-pose pathway and split message passing
        "vn_dgcnn_equiv_inv": (lambda: VN_DGCNN(feat_dim=128, both=True, dtype=dtype), 1024),
        # [equiv(1536) ‖ inv(512)]: mean ‖ soft max-norm pooling
        "vn_dgcnn_rich": (lambda: VN_DGCNN(feat_dim=128, both=True, pool="mean_maxnorm", dtype=dtype), 2048),
        "vnn": (lambda: VNPointNetEncoder(output_dim=2104, dtype=dtype), 2104),
    }
    if name not in table:
        raise ValueError(f"unknown point backbone {name!r}")
    fn, dim = table[name]
    return fn(), dim
