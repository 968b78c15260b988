"""Visual patch helpers — port of the JAX package's ``nn/visual.py:35-45``."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.4850, 0.4560, 0.4060)
IMAGENET_STD = (0.2290, 0.2240, 0.2250)


def normalize_patches(patches: torch.Tensor) -> torch.Tensor:
    """ImageNet mean/std normalization; patches (..., H, W, 3) in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=patches.dtype, device=patches.device)
    std = torch.tensor(IMAGENET_STD, dtype=patches.dtype, device=patches.device)
    return (patches - mean) / std
