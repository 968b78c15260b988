"""Host-side patchification and grid-target construction (numpy).

Port of the JAX package's ``data/patchify.py`` (numpy branch only; the JAX
package's optional native C++ branch produces the same bytes). Non-overlapping
patch_size² patches in (row, col) order with targets on the [-1, 1]² grid,
where node k = row·W + col has target (x, y) = (linspace(-1,1,W)[col],
linspace(-1,1,H)[row]). Rotation augmentation rotates each patch's pixels by
k·90° and appends the unit vector ``ROT_VECTORS[k]`` to the pose target.
"""

from __future__ import annotations

import numpy as np

# k·90° rotation → unit vector (cos, sin)
ROT_VECTORS = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]], dtype=np.float32)


def grid_positions(patch_h: int, patch_w: int) -> np.ndarray:
    """(H·W, 2) targets in [-1,1]², row-major, (x, y) per node."""
    y = np.linspace(-1.0, 1.0, patch_h, dtype=np.float32)
    x = np.linspace(-1.0, 1.0, patch_w, dtype=np.float32)
    gx, gy = np.meshgrid(x, y)  # (H, W) each
    return np.stack([gx, gy], axis=-1).reshape(-1, 2)


def patchify(img: np.ndarray, patch_h: int, patch_w: int, patch_size: int) -> np.ndarray:
    """(H·ps, W·ps, 3) image → (H·W, ps, ps, 3) patches, row-major order."""
    h, w = patch_h * patch_size, patch_w * patch_size
    if img.shape[:2] != (h, w):
        raise ValueError(f"image {img.shape} vs grid {(h, w)}")
    p = img.reshape(patch_h, patch_size, patch_w, patch_size, -1)
    return p.transpose(0, 2, 1, 3, 4).reshape(patch_h * patch_w, patch_size, patch_size, -1)


def unpatchify(patches: np.ndarray, patch_h: int, patch_w: int) -> np.ndarray:
    """Inverse of patchify: (H·W, ps, ps, C) → (H·ps, W·ps, C)."""
    n, ps, _, c = patches.shape
    p = patches.reshape(patch_h, patch_w, ps, ps, c)
    return p.transpose(0, 2, 1, 3, 4).reshape(patch_h * ps, patch_w * ps, c)


def rotate_patches(patches: np.ndarray, rot_k: np.ndarray) -> np.ndarray:
    """Rotate each patch by k·90° CCW (array of k per patch)."""
    out = np.empty_like(patches)
    for k in range(4):
        sel = rot_k == k
        if sel.any():
            out[sel] = np.rot90(patches[sel], k=k, axes=(1, 2))
    return out


def make_puzzle(
    img: np.ndarray,
    patch_h: int,
    patch_w: int,
    patch_size: int = 32,
    rotation: bool = False,
    rng: np.random.Generator | None = None,
) -> dict:
    """Build one puzzle sample from an image in [0,1] float32 (H·ps, W·ps, 3).

    Returns dict with:
        patches: (N, ps, ps, 3) — rotated if `rotation`
        x0:      (N, 2) or (N, 4) pose targets ((x, y) grid [+ rot unit vec])
        grid:    (N, 2) anchor grid (= x0[:, :2])
        rot_k:   (N,) int — applied k·90° rotation (zeros if not rotation)
    """
    patches = patchify(img, patch_h, patch_w, patch_size)
    grid = grid_positions(patch_h, patch_w)
    n = patches.shape[0]
    if rotation:
        if rng is None:
            rng = np.random.default_rng()
        rot_k = rng.integers(0, 4, size=n)
        patches = rotate_patches(patches, rot_k)
        x0 = np.concatenate([grid, ROT_VECTORS[rot_k]], axis=-1)
    else:
        rot_k = np.zeros(n, dtype=np.int64)
        x0 = grid.copy()
    return {"patches": patches, "x0": x0, "grid": grid, "rot_k": rot_k}
