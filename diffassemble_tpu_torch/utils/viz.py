"""Reassembled-image rendering — port of the JAX package's ``utils/viz.py:18-49``."""

from __future__ import annotations

import numpy as np


def compose_from_positions(
    patches: np.ndarray,
    positions: np.ndarray,
    patches_dim: tuple[int, int],
    rotations: np.ndarray | None = None,
) -> np.ndarray:
    """Render (N, ps, ps, 3) patches at (N, 2) positions → (H·ps, W·ps, 3).

    Positions are snapped to the nearest grid cell. A patch with rotation
    vector r is rotated back by −k·90° before placement.
    """
    h, w = patches_dim
    if patches.dtype == np.uint8:
        patches = patches.astype(np.float32) / 255.0
    ps = patches.shape[1]
    canvas = np.zeros((h * ps, w * ps, 3), dtype=np.float32)
    xs = np.linspace(-1, 1, w)
    ys = np.linspace(-1, 1, h)
    for i in range(len(patches)):
        cx = int(np.argmin(np.abs(xs - positions[i, 0])))
        cy = int(np.argmin(np.abs(ys - positions[i, 1])))
        patch = patches[i]
        if rotations is not None:
            ang = np.arctan2(rotations[i, 1], rotations[i, 0])
            k = int(np.round(ang / (np.pi / 2))) % 4
            patch = np.rot90(patch, k=-k, axes=(0, 1))
        canvas[cy * ps : (cy + 1) * ps, cx * ps : (cx + 1) * ps] = patch
    return canvas
