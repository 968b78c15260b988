"""Vector-Neuron (VN) SO(3)-equivariant point-cloud encoder — port of the JAX
package's ``nn/vn.py`` (``VNLinear``, ``VNLeakyReLU``, ``VNNorm``,
``VNLinearLeakyReLU``, ``VNStdFeature``, ``vn_graph_feature``, ``VN_DGCNN``
and ``VNPointNetEncoder``).

Features are laid out (..., N_points, C, 3): every VN linear is one channel
mix over C, and the DGCNN graph is a kNN over the flattened 3C features
(``ops/knn.py``). In bf16 the reductions (sums, means, variances and the
channel mixes) accumulate in f32 and round once, and every elementwise
operation rounds to bf16, where the JAX package rounds on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.knn import knn_indices
from ..ops.so3 import f32_matmuls
from .layers import Dense, _group_moments

_EPS = 1e-6


def _sum(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """Sum accumulated in f32, in x's type."""
    return x.float().sum(dim=dim, keepdim=keepdim).to(x.dtype)


def _mean(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """Mean accumulated in f32, in x's type."""
    return x.float().mean(dim=dim, keepdim=keepdim).to(x.dtype)


class VNLinear(Dense):
    """Channel-mixing linear over vector features: (..., C, 3) → (..., D, 3),
    bias-free; the weight is (D, C) and is rounded to the input's type."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        with f32_matmuls():
            y = torch.nn.functional.linear(x.transpose(-1, -2).float(), self.weight.to(dt).float())
        return y.to(dt).transpose(-1, -2)


def _vn_leaky(p: torch.Tensor, d: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """Direction-gated leaky ReLU on vector features, with the JAX package's
    scale-aware floor on the denominator (1e-3 of the mean channel energy)."""
    dot = _sum(p * d, -1, keepdim=True)
    d_norm_sq = _sum(d * d, -1, keepdim=True)
    floor = 1e-3 * _mean(d_norm_sq, -2, keepdim=True) + _EPS
    reflected = p - (dot / (d_norm_sq + floor)) * d
    gated = torch.where(dot >= 0, p, reflected)
    return negative_slope * p + (1 - negative_slope) * gated


class VNLeakyReLU(nn.Module):
    def __init__(self, channels: int, share_nonlinearity: bool = False, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_dir = VNLinear(channels, 1 if share_nonlinearity else channels)

    def forward(self, x):
        return _vn_leaky(x, self.map_to_dir(x), self.negative_slope)


class VNNorm(nn.Module):
    """Stateless stand-in for VNBatchNorm: per-channel vector norms
    standardized over the point axes (``point_axes`` of the (..., C, 3)
    input), the gain soft-bounded at 16, each vector rescaled with its
    direction kept.

    As in the JAX package, each point axis is shifted by one for the norms'
    kept axis, so the statistics run over the axis before each one named:
    (-3,) on (B, N, C, 3) is the batch axis, (-4, -3) on (B, N, k, C, 3) the
    batch and point axes. While ``stats_group`` holds a process group
    (``parallel.mesh.global_statistics``), statistics that span the batch
    axis span the group's ranks, as XLA's are over a dp-sharded batch."""

    def __init__(self, channels: int, point_axes: tuple = (-3,), epsilon: float = 1e-5):
        super().__init__()
        self.point_axes = point_axes
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))  # the JAX package's ``scale``
        self.bias = nn.Parameter(torch.zeros(channels))
        self.stats_group = None

    def reference_init(self, normal) -> None:
        del normal
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):  # (..., [K,] C, 3)
        dt = x.dtype
        norm = torch.sqrt(_sum(x * x, -1, keepdim=True) + _EPS**2)
        axes = tuple(a - 1 for a in self.point_axes)  # the keepdim axis
        dims = tuple(a % norm.ndim for a in axes)
        if self.stats_group is not None and 0 in dims:
            mu, var = (m.to(dt) for m in _group_moments(norm.float(), self.stats_group, dims))
        else:
            mu = _mean(norm, axes, keepdim=True)
            var = norm.float().var(dim=axes, unbiased=False, keepdim=True).to(dt)
        std = (norm - mu) * torch.reciprocal(torch.sqrt(var + self.epsilon))
        std = 16.0 * torch.tanh(std / 16.0)
        target = std * self.weight[:, None].to(dt) + self.bias[:, None].to(dt)
        denom = norm + 1e-3 * mu + _EPS
        return x / denom * target


class VNLinearLeakyReLU(nn.Module):
    """Linear → norm standardization → direction-gated LeakyReLU."""

    def __init__(self, in_channels: int, out_channels: int, share_nonlinearity: bool = False,
                 negative_slope: float = 0.2, point_axes: tuple = (-3,), use_norm: bool = True):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_feat = VNLinear(in_channels, out_channels)
        self.norm = VNNorm(out_channels, point_axes) if use_norm else None
        self.map_to_dir = VNLinear(in_channels, 1 if share_nonlinearity else out_channels)

    def forward(self, x):
        p = self.map_to_feat(x)
        if self.norm is not None:
            p = self.norm(p)
        return _vn_leaky(p, self.map_to_dir(x), self.negative_slope)


class VNStdFeature(nn.Module):
    """Invariant head: a learned 3-frame z0 from x, x contracted against it.
    Returns (x_std (..., C, 3), z0 (..., 3, 3))."""

    def __init__(self, channels: int, negative_slope: float = 0.2, point_axes: tuple = ()):
        super().__init__()
        use_norm = bool(point_axes)
        self.layers = nn.ModuleList([
            VNLinearLeakyReLU(channels, channels // 2, negative_slope=negative_slope, point_axes=point_axes,
                              use_norm=use_norm),
            VNLinearLeakyReLU(channels // 2, channels // 4, negative_slope=negative_slope,
                              point_axes=point_axes, use_norm=use_norm),
        ])
        self.frame = VNLinear(channels // 4, 3)

    def forward(self, x):
        z = x
        for layer in self.layers:
            z = layer(z)
        z0 = self.frame(z)
        with f32_matmuls():
            x_std = torch.matmul(x.float(), z0.float().transpose(-1, -2)).to(x.dtype)
        return x_std, z0


def _gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C, 3), idx (B, N, k) → (B, N, k, C, 3)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


def vn_graph_feature(x: torch.Tensor, k: int) -> torch.Tensor:
    """DGCNN edge features on vector channels: x (B, N, C, 3) → (B, N, k, 2C, 3)
    of [neighbour − centre ‖ centre], kNN in the flattened 3C feature space."""
    b, n, c, _ = x.shape
    idx = knn_indices(x.reshape(b, n, c * 3), k)
    nbrs = _gather_neighbors(x, idx)
    center = x[:, :, None].expand(b, n, k, c, 3)
    return torch.cat([nbrs - center, center], dim=-2)


def _softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax as the JAX package computes it: exp(x − max) in x's type, its
    sum accumulated in f32, the quotient in x's type."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / _sum(e, dim, keepdim=True)


class VN_DGCNN(nn.Module):
    """VN dynamic-graph CNN over one part's point cloud.

    (B, N, 3) points → equivariant (B, 2·feat_dim·3) features, invariant
    (B, 2·feat_dim) with ``invariant``, or [equivariant ‖ invariant] with
    ``both``; ``pool="mean_maxnorm"`` concatenates to the mean pool a soft
    max-norm pool (a softmax over points of the standardized ‖h‖² of each
    channel), doubling the pooled channels. ``return_points`` also returns
    per-point rotation-invariant descriptors (B, N, 63 + feat_dim): the
    channel norms of the multi-scale VN features before pooling, the
    correspondence head's input."""

    def __init__(self, feat_dim: int = 128, n_knn: int = 20, invariant: bool = False, both: bool = False,
                 pool: str = "mean", dtype: torch.dtype = torch.float32, return_points: bool = False):
        super().__init__()
        if pool not in ("mean", "mean_maxnorm"):
            raise ValueError(f"unknown pool {pool!r}")
        self.feat_dim, self.n_knn, self.invariant, self.both, self.pool = feat_dim, n_knn, invariant, both, pool
        self.return_points = return_points
        self.compute_dtype = dtype
        w = 64 // 3  # 21 channels
        edge = (-4, -3)
        self.layers = nn.ModuleList([
            VNLinearLeakyReLU(2, w, point_axes=edge),
            VNLinearLeakyReLU(w, w, point_axes=edge),
            VNLinearLeakyReLU(2 * w, w, point_axes=edge),
            VNLinearLeakyReLU(w, w, point_axes=edge),
            VNLinearLeakyReLU(2 * w, w, point_axes=edge),
            VNLinearLeakyReLU(3 * w, feat_dim, share_nonlinearity=True, point_axes=(-3,)),
        ])
        pooled = 2 * feat_dim * (2 if pool == "mean_maxnorm" else 1)
        self.std_feature = VNStdFeature(pooled) if (invariant or both) else None

    @property
    def output_dim(self) -> int:
        pooled = 2 * self.feat_dim * (2 if self.pool == "mean_maxnorm" else 1)
        if self.invariant:
            return pooled
        if self.both:
            return 4 * pooled
        return 3 * pooled

    def forward(self, pts):
        b = pts.shape[0]
        x = pts[:, :, None, :].to(self.compute_dtype)  # (B, N, 1, 3)
        conv = self.layers

        g = conv[1](conv[0](vn_graph_feature(x, self.n_knn)))
        x1 = _mean(g, 2)  # mean pool over the k neighbours
        g = conv[3](conv[2](vn_graph_feature(x1, self.n_knn)))
        x2 = _mean(g, 2)
        x3 = _mean(conv[4](vn_graph_feature(x2, self.n_knn)), 2)

        x123 = torch.cat([x1, x2, x3], dim=-2)  # (B, N, 63, 3)
        h = conv[5](x123)  # (B, N, feat, 3)
        point_desc = None
        if self.return_points:  # the mean bank below is the same at every point: left out
            loc = torch.cat([x123, h], dim=-2)
            point_desc = torch.sqrt(_sum(loc * loc, -1) + _EPS**2)
        h = torch.cat([h, _mean(h, 1, keepdim=True).expand(h.shape)], dim=-2)  # (B, N, 2·feat, 3)
        pooled = _mean(h, 1)  # (B, 2·feat, 3)
        if self.pool == "mean_maxnorm":
            n2 = _sum(h * h, -1)  # (B, N, 2·feat)
            n2c = n2 - _mean(n2, 1, keepdim=True)
            var = _mean(n2c * n2c, 1, keepdim=True)
            # no gradient through the normaliser, as in the JAX package: its
            # derivative grows as var^-1.5 on channels of near-zero variance
            w = _softmax(5.0 * (n2c * torch.rsqrt(var + 1e-12).detach()), dim=1)
            with f32_matmuls():
                sel = torch.einsum("bnc,bncv->bcv", w.float(), h.float()).to(h.dtype)
            pooled = torch.cat([pooled, sel], dim=-2)  # (B, 4·feat, 3)
        h = pooled

        if self.invariant:
            out = _mean(self.std_feature(h)[0], -1)
        elif self.both:
            out = torch.cat([h.reshape(b, -1), _mean(self.std_feature(h)[0], -1)], dim=-1)
        else:
            out = h.reshape(b, -1)
        return (out, point_desc) if self.return_points else out


class VNPointNetEncoder(nn.Module):
    """VN-PointNet global encoder (the ``vnn`` backbone): a VN layer on the
    kNN edge features, mean-pooled over the neighbours, two more VN layers
    and a VN linear to 341 channels per point, mean-pooled over the points to
    one global vector feature, flattened (1023) and projected by a Dense to
    ``output_dim``."""

    def __init__(self, output_dim: int = 2104, n_knn: int = 20, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_knn, self.compute_dtype = n_knn, dtype
        self.layers = nn.ModuleList([
            VNLinearLeakyReLU(2, 21, point_axes=(-4, -3)),
            VNLinearLeakyReLU(21, 64, point_axes=(-3,)),
            VNLinearLeakyReLU(64, 128, point_axes=(-3,)),
        ])
        self.vn_out = VNLinear(128, 341)  # ≈1024 // 3 channels
        self.fc1 = Dense(341 * 3, output_dim, dtype=dtype)

    def forward(self, pts):  # (B, N, 3)
        b = pts.shape[0]
        x = pts[:, :, None, :].to(self.compute_dtype)
        x1 = _mean(self.layers[0](vn_graph_feature(x, self.n_knn)), 2)
        x1 = self.vn_out(self.layers[2](self.layers[1](x1)))
        return self.fc1(_mean(x1, 1).reshape(b, -1))
