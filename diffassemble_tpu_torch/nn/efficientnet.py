"""EfficientNet-B0 feature tower — port of the JAX package's ``nn/efficientnet.py``.

B0 through stage 4, tapping stage 2 (40ch @ /8) and stage 4 (112ch @ /16),
each flattened in NCHW order and concatenated: 40·4·4 + 112·2·2 = 1088 dims
for 32×32 patches.

    stem   Conv3×3 s2 32ch → BN → SiLU
    stage0 DS-conv   ×1 k3 s1 →  16ch
    stage1 MBConv6   ×2 k3 s2 →  24ch
    stage2 MBConv6   ×2 k5 s2 →  40ch   ← tap
    stage3 MBConv6   ×3 k3 s2 →  80ch
    stage4 MBConv6   ×3 k5 s1 → 112ch   ← tap

Symmetric k//2 padding, SE ratio 0.25 of the block input channels, SiLU.
Submodule names follow timm's (conv_stem, bn1, blocks.{s}.{b}.{conv_pw, bn1,
conv_dw, bn2, se_reduce, se_expand, conv_pwl, bn3}), which are also the JAX
package's names, so ``convert.py`` maps the parameters one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2D, Conv2d
from .visual import normalize_patches

# (num_blocks, kernel, stride, expand_ratio, out_channels) per stage
B0_STAGES = (
    (1, 3, 1, 1, 16),
    (2, 3, 2, 6, 24),
    (2, 5, 2, 6, 40),   # ← tap
    (3, 3, 2, 6, 80),
    (3, 5, 1, 6, 112),  # ← tap
)
_TAPS = (2, 4)


class MBConv(nn.Module):
    """Inverted-residual MBConv (depthwise-separable when expand == 1)."""

    def __init__(self, c_in: int, out_ch: int, kernel: int, stride: int, expand: int,
                 bn_mode: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = c_in * expand
        se_r = max(1, c_in // 4)
        self.expand = expand
        self.residual = stride == 1 and c_in == out_ch
        if expand != 1:
            self.conv_pw = Conv2d(c_in, mid, 1, dtype=dtype)
            self.bn1 = BatchNorm2D(mid, bn_mode)
            self.conv_dw = Conv2d(mid, mid, kernel, stride, groups=mid, dtype=dtype)
            self.bn2 = BatchNorm2D(mid, bn_mode)
            self.conv_pwl = Conv2d(mid, out_ch, 1, dtype=dtype)
            self.bn3 = BatchNorm2D(out_ch, bn_mode)
        else:
            self.conv_dw = Conv2d(mid, mid, kernel, stride, groups=mid, dtype=dtype)
            self.bn1 = BatchNorm2D(mid, bn_mode)
            self.conv_pw = Conv2d(mid, out_ch, 1, dtype=dtype)
            self.bn2 = BatchNorm2D(out_ch, bn_mode)
        self.se_reduce = Conv2d(mid, se_r, 1, bias=True, dtype=dtype)
        self.se_expand = Conv2d(se_r, mid, 1, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand != 1:
            h = F.silu(self.bn1(self.conv_pw(h)))
            h = F.silu(self.bn2(self.conv_dw(h)))
        else:
            h = F.silu(self.bn1(self.conv_dw(h)))
        s = h.mean(dim=(2, 3), keepdim=True)
        s = self.se_expand(F.silu(self.se_reduce(s)))
        h = h * torch.sigmoid(s)
        if self.expand != 1:
            h = self.bn3(self.conv_pwl(h))
        else:
            h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class EfficientNetB0Features(nn.Module):
    """(B, H, W, 3) patches in [0, 1] → (B, 1088) [stage-2 tap ‖ stage-4 tap]."""

    feature_dim = 1088  # for 32×32 inputs

    def __init__(self, bn_mode: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_stem = Conv2d(3, 32, 3, 2, dtype=dtype)
        self.bn1 = BatchNorm2D(32, bn_mode)
        stages = []
        c_in = 32
        for n_blocks, k, stride, expand, out_ch in B0_STAGES:
            blocks = []
            for i in range(n_blocks):
                blocks.append(MBConv(c_in, out_ch, k, stride if i == 0 else 1, expand, bn_mode, dtype))
                c_in = out_ch
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = normalize_patches(x).permute(0, 3, 1, 2)  # NHWC → NCHW
        x = F.silu(self.bn1(self.conv_stem(x)))
        taps = []
        for s, stage in enumerate(self.blocks):
            for block in stage:
                x = block(x)
            if s in _TAPS:
                taps.append(x.reshape(b, -1))  # NCHW flatten, as the JAX tower does
        return torch.cat(taps, dim=-1)
