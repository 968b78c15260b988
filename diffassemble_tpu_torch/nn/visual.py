"""Visual patch encoders — port of the JAX package's ``nn/visual.py``.

- ``normalize_patches``: ImageNet mean/std normalization.
- The C4 (p4) and D4 (p4m) group convolutions ``GroupConvZ2``,
  ``GroupConvP4``, ``GroupConvZ2M``, ``GroupConvP4M``: each kernel parameter
  keeps the JAX package's shape, (k, k, Cin, Cout) or (k, k, |G|, Cin, Cout),
  and every call builds the one big HWIO kernel from it (spatial rot90/flip
  plus a permutation of the input-orientation axis per output element) and
  runs one ``F.conv2d``. Activations are NCHW with the channel axis
  orientation-major (channel g·C + c), which is the JAX package's
  (B, H, W, |G|, C) reshaped; "SAME" padding is XLA's (the odd pixel of a
  stride-2 3×3 conv on an even input goes to the high side).
- ``OrientationNorm``: statistics in f32 over (batch, H, W, orientation) per
  channel, eps 1e-5; batch statistics, or the frozen ``norm_stats`` attached
  to it (``set_norm_stats``), or recording each call's mean and E[x²] for
  calibration (``calibrate_norm_stats``). Under data-parallel training
  (``parallel.mesh.global_statistics`` sets ``stats_group``) the statistics
  span the group's ranks, as XLA's are over a dp-sharded batch.
- ``EquivariantResNet`` (18, 34) and ``EquivariantResNet50``: 32×32 patches
  → (B, 1088), two stage taps through 544-wide ``proj3`` and ``proj4``,
  which read the (H, W, orientation, C) flattening.
- ``PatchConvEncoder`` ("convnet", conv → GroupNorm → SiLU blocks with
  XLA's "SAME" padding, two NHWC-flattened taps) and ``TinyPatchEncoder``
  ("tiny", a 4×4 average-pool grid through two Dense layers): 32×32
  patches → (B, 1088).
- ``make_visual_encoder``: the backbone switch.

``norm_layers(encoder)`` names each OrientationNorm by its JAX path
(``OrientationNorm_0``, ``EquivariantBasicBlock_3/OrientationNorm_1``, ...),
which is also the key layout of a ``norm_stats.npz``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Dense, _group_moments, gelu

IMAGENET_MEAN = (0.4850, 0.4560, 0.4060)
IMAGENET_STD = (0.2290, 0.2240, 0.2250)
FEATURE_DIM = 1088  # every 2D encoder's output width for 32×32 patches


def normalize_patches(patches: torch.Tensor) -> torch.Tensor:
    """ImageNet mean/std normalization; patches (..., H, W, 3) in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=patches.dtype, device=patches.device)
    std = torch.tensor(IMAGENET_STD, dtype=patches.dtype, device=patches.device)
    return (patches - mean) / std


# --------------------------------------------------------------- group convolutions

# D4 element g = (m, r): plane action x → Mirror^m Rot90^r x, indexed m·4 + r
_D4 = [(m, r) for m in range(2) for r in range(4)]


def _d4_mul(a: tuple, b: tuple) -> tuple:
    """(M^am R^ar)(M^bm R^br) = M^(am+bm) R^(((-1)^bm)·ar + br)."""
    am, ar = a
    bm, br = b
    return ((am + bm) % 2, (((-1) ** bm) * ar + br) % 4)


def _d4_inv(a: tuple) -> tuple:
    am, ar = a
    return (am, (-((-1) ** am) * ar) % 4)


def _d4_spatial(w: torch.Tensor, g: tuple) -> torch.Tensor:
    """D4 element g on the spatial axes (0, 1) of an HWIO-style kernel."""
    m, r = g
    out = torch.rot90(w, r, dims=(0, 1))
    return torch.flip(out, dims=(1,)) if m else out


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """XLA's "SAME" padding of NCHW ``x`` for a k×k window at ``stride``."""

    def pads(n: int) -> tuple[int, int]:
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        return total // 2, total - total // 2

    (top, bottom), (left, right) = pads(x.shape[2]), pads(x.shape[3])
    return F.pad(x, (left, right, top, bottom)) if top or bottom or left or right else x


class _GroupConv(nn.Module):
    """One group convolution: ``kernel`` in the JAX package's shape, the big
    HWIO kernel built per call (``big_kernel``), one ``F.conv2d``.
    Input NCHW with ``in_group``·Cin channels, output ``group``·features."""

    group = 4
    in_group = 1  # 1: a lifting convolution from the plane

    def __init__(self, c_in: int, features: int, kernel_size: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        shape = (k, k, c_in, features) if self.in_group == 1 else (k, k, self.in_group, c_in, features)
        self.kernel = nn.Parameter(torch.zeros(shape))
        self.features, self.kernel_size, self.stride = features, k, stride
        self.compute_dtype = dtype

    def reference_init(self, normal) -> None:
        """He normal: std √(2/fan_in), fan_in every axis but the last (the JAX package's init)."""
        normal(self.kernel, math.sqrt(2.0 / math.prod(self.kernel.shape[:-1])))

    def big_kernel(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        big = self.big_kernel(self.kernel.to(dt)).permute(3, 2, 0, 1)  # HWIO → OIHW
        return F.conv2d(_same_pad(x.to(dt), self.kernel_size, self.stride), big, stride=self.stride)


class GroupConvZ2(_GroupConv):
    """Z2 → p4 lifting convolution: (B, Cin, H, W) → (B, 4·Cout, H', W')."""

    def big_kernel(self, w):
        return torch.cat([torch.rot90(w, r, dims=(0, 1)) for r in range(4)], dim=-1)


class GroupConvP4(_GroupConv):
    """p4 → p4 group convolution: (B, 4·Cin, H, W) → (B, 4·Cout, H', W'); for
    output orientation r the kernel is rotated by r and its input-orientation
    axis rolled by r."""

    in_group = 4

    def big_kernel(self, w):
        k, _, g, cin, cout = w.shape
        return torch.cat([torch.roll(torch.rot90(w, r, dims=(0, 1)), r, dims=2).reshape(k, k, g * cin, cout)
                          for r in range(4)], dim=-1)


class GroupConvZ2M(_GroupConv):
    """Z2 → p4m lifting convolution: (B, Cin, H, W) → (B, 8·Cout, H', W')."""

    group = 8

    def big_kernel(self, w):
        return torch.cat([_d4_spatial(w, g) for g in _D4], dim=-1)


class GroupConvP4M(_GroupConv):
    """p4m → p4m group convolution: (B, 8·Cin, H, W) → (B, 8·Cout, H', W');
    for output element h the kernel is spatially transformed by h and its
    group axis permuted by g ↦ h⁻¹∘g."""

    group = 8
    in_group = 8

    def big_kernel(self, w):
        k, _, g, cin, cout = w.shape
        out = []
        for h in _D4:
            perm = [_D4.index(_d4_mul(_d4_inv(h), e)) for e in _D4]
            out.append(_d4_spatial(w[:, :, perm], h).reshape(k, k, g * cin, cout))
        return torch.cat(out, dim=-1)


# -------------------------------------------------------------------- OrientationNorm


class OrientationNorm(nn.Module):
    """Norm over (batch, H, W, orientation) per channel of NCHW (B, G·C, H, W)
    input, in f32, returning the input's type: batch statistics; or the frozen
    ``frozen_mean``/``frozen_var`` (non-persistent buffers of shape (C,),
    ``set_norm_stats``); while ``recorded`` is a list, each call appends its
    batch mean and E[x²] (each (C,)) to it."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("frozen_mean", None, persistent=False)
        self.register_buffer("frozen_var", None, persistent=False)
        self.recorded: list | None = None
        self.stats_group = None

    def reference_init(self, normal) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, gc, h, w = x.shape
        c = self.weight.shape[0]
        xf = x.float().reshape(b * (gc // c), c, h, w)  # orientation joins the batch axis
        if self.frozen_mean is not None and self.recorded is None:
            mean, var = self.frozen_mean.reshape(1, c, 1, 1), self.frozen_var.reshape(1, c, 1, 1)
        else:
            if self.stats_group is None:
                mean = xf.mean(dim=(0, 2, 3), keepdim=True)
                var = (xf - mean).square().mean(dim=(0, 2, 3), keepdim=True)
            else:
                mean, var = _group_moments(xf, self.stats_group)
            if self.recorded is not None:
                # the second moment, not the variance: it pools exactly over calibration batches
                self.recorded.append((mean.detach().reshape(c), (var + mean * mean).detach().reshape(c)))
        y = (xf - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype).reshape(b, gc, h, w)


# --------------------------------------------------------------------- the networks


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, G·C, H, W) → (B, H·W·G·C), the JAX package's (B, H, W, G, C) flattened."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class EquivariantBasicBlock(nn.Module):
    """C4-equivariant ResNet BasicBlock; JAX names in ``_norm_names``."""

    def __init__(self, c_in: int, features: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = GroupConvP4(c_in, features, 3, stride, dtype)
        self.norm1 = OrientationNorm(features)
        self.conv2 = GroupConvP4(features, features, 3, 1, dtype)
        self.norm2 = OrientationNorm(features)
        self.shortcut = self.shortcut_norm = None
        if stride != 1 or c_in != features:
            self.shortcut = GroupConvP4(c_in, features, 1, stride, dtype)
            self.shortcut_norm = OrientationNorm(features)

    def norm_layers(self):
        """(JAX name, OrientationNorm) in the JAX package's creation order."""
        norms = [self.norm1, self.norm2] + ([self.shortcut_norm] if self.shortcut is not None else [])
        return [(f"OrientationNorm_{i}", m) for i, m in enumerate(norms)]

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        h = self.norm2(self.conv2(h))
        if self.shortcut is not None:
            x = self.shortcut_norm(self.shortcut(x))
        return F.relu(x + h)


class EquivariantBottleneck(nn.Module):
    """C4-equivariant ResNet Bottleneck: 1×1 reduce → 3×3 → 1×1 expand (4×)."""

    def __init__(self, c_in: int, features: int, stride: int = 1, expansion: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = features * expansion
        self.conv1 = GroupConvP4(c_in, features, 1, 1, dtype)
        self.norm1 = OrientationNorm(features)
        self.conv2 = GroupConvP4(features, features, 3, stride, dtype)
        self.norm2 = OrientationNorm(features)
        self.conv3 = GroupConvP4(features, out_ch, 1, 1, dtype)
        self.norm3 = OrientationNorm(out_ch)
        self.shortcut = self.shortcut_norm = None
        if stride != 1 or c_in != out_ch:
            self.shortcut = GroupConvP4(c_in, out_ch, 1, stride, dtype)
            self.shortcut_norm = OrientationNorm(out_ch)
        self.out_channels = out_ch

    def norm_layers(self):
        norms = [self.norm1, self.norm2, self.norm3] + ([self.shortcut_norm] if self.shortcut is not None else [])
        return [(f"OrientationNorm_{i}", m) for i, m in enumerate(norms)]

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        h = self.norm3(self.conv3(h))
        if self.shortcut is not None:
            x = self.shortcut_norm(self.shortcut(x))
        return F.relu(x + h)


class _EquivariantTower(nn.Module):
    """Stem (lift + norm + ReLU), ``blocks`` with a tap after the first
    ``n_tap3``, the 544-wide ``proj3``/``proj4`` taps → (B, 1088)."""

    feature_dim = FEATURE_DIM

    def _finish(self, blocks: list[nn.Module], n_tap3: int, tap_shapes: list[tuple[int, int]], dtype) -> None:
        self.blocks = nn.ModuleList(blocks)
        self.n_tap3 = n_tap3
        (c3, s3), (c4, s4) = tap_shapes
        self.proj3 = Dense(s3 * s3 * 4 * c3, FEATURE_DIM // 2, dtype=dtype)
        self.proj4 = Dense(s4 * s4 * 4 * c4, FEATURE_DIM // 2, dtype=dtype)

    def norm_layers(self):
        out = [("OrientationNorm_0", self.stem_norm)]
        for k, block in enumerate(self.blocks):
            out += [(f"{type(block).__name__}_{k}/{name}", m) for name, m in block.norm_layers()]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) patches in [0, 1] → (B, 1088)."""
        x = normalize_patches(x).permute(0, 3, 1, 2)
        x = F.relu(self.stem_norm(self.stem(x)))
        tap3 = None
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i == self.n_tap3 - 1:
                tap3 = self.proj3(_flatten_nhwc(x))
        return torch.cat([tap3, self.proj4(_flatten_nhwc(x))], dim=-1)


class EquivariantResNet(_EquivariantTower):
    """C4-equivariant ResNet: stem 32ch stride 1, stages [32, 64, 64, 128]
    with strides [1, 2, 2, 2] of ``blocks`` BasicBlocks each, taps at stages 3
    and 4. ResNet18 = (2, 2, 2, 2), ResNet34 = (3, 4, 6, 3)."""

    def __init__(self, blocks=(2, 2, 2, 2), dtype: torch.dtype = torch.float32, patch_size: int = 32):
        super().__init__()
        self.stem = GroupConvZ2(3, 32, 3, 1, dtype)
        self.stem_norm = OrientationNorm(32)
        layers, c, size, taps = [], 32, patch_size, []
        for s, (features, stride) in enumerate(((32, 1), (64, 2), (64, 2), (128, 2))):
            for i in range(blocks[s]):
                layers.append(EquivariantBasicBlock(c, features, stride if i == 0 else 1, dtype))
                c = features
            size = -(-size // stride)
            if s >= 2:
                taps.append((c, size))
        self._finish(layers, sum(blocks[:3]), taps, dtype)


class EquivariantResNet50(_EquivariantTower):
    """Bottleneck C4-equivariant ResNet50: stages of (16, 1, 3), (16, 2, 4),
    (16, 2, 6) bottlenecks (×4 expansion), tap, then 3 of width 32 at stride
    2, tap."""

    def __init__(self, dtype: torch.dtype = torch.float32, patch_size: int = 32):
        super().__init__()
        self.stem = GroupConvZ2(3, 32, 3, 1, dtype)
        self.stem_norm = OrientationNorm(32)
        layers, c, size, taps = [], 32, patch_size, []
        for s, (features, stride, n) in enumerate(((16, 1, 3), (16, 2, 4), (16, 2, 6), (32, 2, 3))):
            for i in range(n):
                layers.append(EquivariantBottleneck(c, features, stride if i == 0 else 1, dtype=dtype))
                c = layers[-1].out_channels
            size = -(-size // stride)
            if s >= 2:
                taps.append((c, size))
        self._finish(layers, 13, taps, dtype)


def EquivariantResNet18(dtype: torch.dtype = torch.float32, patch_size: int = 32) -> EquivariantResNet:
    return EquivariantResNet((2, 2, 2, 2), dtype, patch_size)


def EquivariantResNet34(dtype: torch.dtype = torch.float32, patch_size: int = 32) -> EquivariantResNet:
    return EquivariantResNet((3, 4, 6, 3), dtype, patch_size)


EQUIVARIANT_BACKBONES = {"resnet18equiv": EquivariantResNet18, "resnet34equiv": EquivariantResNet34,
                         "resnet50equiv": EquivariantResNet50}


# ------------------------------------------------------------ the light encoders


class _SameConv(Conv2d):
    """A bias-free k×k convolution with XLA's "SAME" padding (``_same_pad``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        k, s = self.kernel_size[0], self.stride[0]
        return F.conv2d(_same_pad(x.to(dt), k, s), self.weight.to(dt), stride=s)


class GroupNorm(nn.GroupNorm):
    """The JAX package's ``GroupNorm``: eps 1e-6, statistics in f32, output in ``compute_dtype``."""

    def __init__(self, num_groups: int, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_groups, channels, eps=1e-6)
        self.compute_dtype = dtype

    def reference_init(self, normal) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class ConvBlock(nn.Module):
    """3×3 conv ("SAME", ``stride``) → GroupNorm(min(8, C) groups) → SiLU."""

    def __init__(self, c_in: int, features: int, stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = _SameConv(c_in, features, 3, stride, dtype=dtype)
        self.norm = GroupNorm(min(8, features), features, dtype)

    def forward(self, x):
        return F.silu(self.norm(self.conv(x)))


class ResidualConvBlock(nn.Module):
    """ConvBlock → 3×3 conv → GroupNorm, added to the input (through a 1×1
    ``shortcut`` when the width changes), then SiLU."""

    def __init__(self, c_in: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block = ConvBlock(c_in, features, dtype=dtype)
        self.conv = _SameConv(features, features, 3, dtype=dtype)
        self.norm = GroupNorm(min(8, features), features, dtype)
        self.shortcut = _SameConv(c_in, features, 1, dtype=dtype) if c_in != features else None

    def forward(self, x):
        h = self.norm(self.conv(self.block(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.silu(x + h)


class PatchConvEncoder(nn.Module):
    """"convnet": a multi-scale CNN over 32×32 patches → (B, 1088). Four
    stride-2 ``down`` blocks, each followed by a ``res`` block, at widths
    (32, 24, 40, 112); taps after the third (40 × 4×4 → 640) and the fourth
    (112 × 2×2 → 448), each flattened in the JAX package's NHWC order."""

    def __init__(self, width=(32, 24, 40, 112), dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = (3, *width)
        self.down = nn.ModuleList(ConvBlock(widths[i], widths[i + 1], 2, dtype) for i in range(4))
        self.res = nn.ModuleList(ResidualConvBlock(w, w, dtype) for w in width)
        self.feature_dim = width[2] * 16 + width[3] * 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) patches in [0, 1] → (B, 1088)."""
        x = normalize_patches(x).permute(0, 3, 1, 2)
        taps = []
        for i, (down, res) in enumerate(zip(self.down, self.res)):
            x = res(down(x))
            if i >= 2:
                taps.append(_flatten_nhwc(x))
        return torch.cat(taps, dim=-1)


class TinyPatchEncoder(nn.Module):
    """"tiny": the mean of each cell of a 4×4 grid over the normalized patch
    (NHWC order, 48 values) → Dense(128) → GELU (tanh) → Dense(1088). For fast
    tests and dry runs, with the real encoders' output width."""

    def __init__(self, dtype: torch.dtype = torch.float32, feature_dim: int = FEATURE_DIM):
        super().__init__()
        self.fc1 = Dense(48, 128, dtype=dtype)
        self.fc2 = Dense(128, feature_dim, dtype=dtype)
        self.feature_dim = feature_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) patches in [0, 1] → (B, feature_dim)."""
        x = normalize_patches(x)
        b, h, w, c = x.shape
        x = x.reshape(b, 4, h // 4, 4, w // 4, c).mean(dim=(2, 4)).reshape(b, -1)
        return self.fc2(gelu(self.fc1(x)))


BACKBONES = ("efficientnet_b0", "convnet", "tiny", *EQUIVARIANT_BACKBONES)


def make_visual_encoder(name: str, dtype: torch.dtype = torch.float32, pretrained: bool = False) -> nn.Module:
    """The backbone switch: "efficientnet_b0" (its BatchNorms folded affine
    with ``pretrained``, batch statistics otherwise), "convnet", "tiny" or an
    equivariant ResNet."""
    if name == "efficientnet_b0":
        from .efficientnet import EfficientNetB0Features

        return EfficientNetB0Features(bn_mode="affine" if pretrained else "batch", dtype=dtype)
    if name == "convnet":
        return PatchConvEncoder(dtype=dtype)
    if name == "tiny":
        return TinyPatchEncoder(dtype=dtype)
    if name in EQUIVARIANT_BACKBONES:
        return EQUIVARIANT_BACKBONES[name](dtype=dtype)
    raise ValueError(f"unknown visual backbone {name!r}")


# ------------------------------------------------------------ norm-stats calibration


def norm_layers(encoder: nn.Module) -> list[tuple[str, OrientationNorm]]:
    """(JAX path, OrientationNorm) of every norm layer; [] for an encoder without."""
    return encoder.norm_layers() if hasattr(encoder, "norm_layers") else []


def _flat(stats: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nested(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@torch.no_grad()
def calibrate_norm_stats(encoder: nn.Module, batches) -> dict:
    """OrientationNorm statistics pooled over calibration batches (each a
    (B, ps, ps, 3) array or tensor in [0, 1]; equal sizes pool exactly): the
    mean of the batch means and of the batch second moments, then the
    variance E[x²] − mean² clamped at 0. Returns the JAX package's nested
    ``norm_stats`` layout, {path...: {"mean", "var"}} with arrays of shape
    (1, 1, 1, 1, C) in f32 on the encoder's device, or {} for an encoder
    without OrientationNorm layers."""
    layers = norm_layers(encoder)
    if not layers:
        return {}
    dev = next(encoder.parameters()).device
    for _, m in layers:
        m.recorded = []
    try:
        n = 0
        for x in batches:
            encoder(torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float32,
                                    device=dev))
            n += 1
        flat = {}
        for path, m in layers:
            if len(m.recorded) != n:
                raise RuntimeError(f"{path} ran {len(m.recorded)} times over {n} batches")
            mean = torch.stack([r[0] for r in m.recorded]).mean(0)
            sq_mean = torch.stack([r[1] for r in m.recorded]).mean(0)
            c = mean.shape[0]
            flat[f"{path}/mean"] = mean.reshape(1, 1, 1, 1, c)
            flat[f"{path}/var"] = torch.clamp(sq_mean - mean * mean, min=0.0).reshape(1, 1, 1, 1, c)
    finally:
        for _, m in layers:
            m.recorded = None
    return _nested(flat) if n else {}


def set_norm_stats(encoder: nn.Module, stats: dict | None) -> None:
    """Attach frozen statistics (the nested layout of ``calibrate_norm_stats``
    or ``load_norm_stats``) to every OrientationNorm, or with None or {}
    detach them (batch statistics again)."""
    layers = norm_layers(encoder)
    flat = _flat(stats) if stats else {}
    missing = [p for p, _ in layers if flat and (f"{p}/mean" not in flat or f"{p}/var" not in flat)]
    if missing or (flat and len(flat) != 2 * len(layers)):
        raise ValueError(f"norm_stats do not match the encoder's OrientationNorm layers (missing {missing}, "
                         f"{len(flat)} arrays for {len(layers)} layers)")
    for path, m in layers:
        if not flat:
            m.frozen_mean = m.frozen_var = None
            continue
        dev = m.weight.device
        m.frozen_mean, m.frozen_var = (torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                                       dtype=torch.float32, device=dev).reshape(-1)
                                       for v in (flat[f"{path}/mean"], flat[f"{path}/var"]))


def save_norm_stats(path, stats: dict) -> None:
    """npz with the JAX package's keys (``OrientationNorm_0/mean``, ...)."""
    np.savez(path, **{k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                      for k, v in _flat(stats).items()})


def load_norm_stats(path) -> dict:
    """A ``norm_stats.npz`` (either package's) → the nested layout, numpy arrays."""
    with np.load(path) as z:
        return _nested({k: z[k] for k in z.files})
