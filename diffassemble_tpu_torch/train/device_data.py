"""Device-resident puzzle corpus — port of the eval half of the JAX package's
``train/device_data.py``.

The whole corpus of same-size puzzles is patchified on the host once and
parked on the device as uint8; each batch is gathered on the device. Rotation
follows the host conventions of ``data/patchify.py``: pixels rotated k·90°
counter-clockwise, pose target ``ROT_VECTORS[k]`` appended. The JAX package
draws k inside ``gather_batch`` from a JAX key; torch cannot reproduce that
draw, so here the caller passes ``rot_k`` itself. The shared expander is the
reference's ``unique_graph`` mode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.batch import PuzzleBatch
from ..data.expander import expander_mask
from ..data.patchify import ROT_VECTORS, grid_positions, patchify
from ..utils.device import resolve_device


class DevicePuzzleData(NamedTuple):
    """A whole corpus of same-size puzzles on one device."""

    patches: torch.Tensor  # (S, N, ps, ps, 3) uint8, unrotated pieces
    grid: torch.Tensor     # (N, 2) float32, shared anchor grid
    adj: torch.Tensor      # (N, N) bool, shared topology
    hw: torch.Tensor       # (2,) int32 (H, W)

    @property
    def n_samples(self) -> int:
        return self.patches.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.patches.shape[1]


def build_device_data(
    images,
    hw: tuple[int, int],
    n_samples: int,
    patch_size: int = 32,
    degree: str | int = -1,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> DevicePuzzleData:
    """Patchify ``n_samples`` images on the host once and move the corpus to
    ``device``.

    ``images[i]`` is a float32 [0, 1] image of shape
    (hw[0]·patch_size, hw[1]·patch_size, 3). ``degree=-1`` is fully connected;
    otherwise one expander from ``np.random.default_rng(seed)``."""
    device = resolve_device(device)
    h, w = hw
    n = h * w
    rng = np.random.default_rng(seed)
    out = np.empty((n_samples, n, patch_size, patch_size, 3), dtype=np.uint8)
    for i in range(n_samples):
        p = patchify(np.asarray(images[i], np.float32), h, w, patch_size)
        out[i] = np.clip(p * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if degree in (-1, "-1"):
        adj = np.ones((n, n), dtype=bool)
    else:
        adj = expander_mask(n, degree if isinstance(degree, str) else int(degree), rng)
    return DevicePuzzleData(
        patches=torch.from_numpy(out).to(device),
        grid=torch.from_numpy(grid_positions(h, w)).to(device),
        adj=torch.from_numpy(adj).to(device),
        hw=torch.tensor([h, w], dtype=torch.int32, device=device),
    )


def gather_batch(data: DevicePuzzleData, idx: torch.Tensor, rot_k: torch.Tensor | None = None) -> PuzzleBatch:
    """The batch of samples ``idx`` (B,), assembled on the data's device.

    With ``rot_k`` (B, N) integers in [0, 4), piece j of sample i is rotated
    by rot_k[i, j]·90°: its pixels through the stack of the four rot90 views,
    its pose target with ``ROT_VECTORS[k]`` appended, as the JAX package's
    ``gather_batch`` does with its own draw."""
    dev = data.patches.device
    idx = idx.to(dev)
    b, n = idx.shape[0], data.n_nodes
    patches = data.patches[idx]  # (B, N, ps, ps, 3) uint8
    grid = data.grid[None].expand(b, n, 2)
    if rot_k is not None:
        rot_k = rot_k.to(device=dev, dtype=torch.int64)
        views = torch.stack([torch.rot90(patches, k, dims=(2, 3)) for k in range(4)])  # (4, B, N, ps, ps, 3)
        patches = views[rot_k, torch.arange(b, device=dev)[:, None], torch.arange(n, device=dev)[None, :]]
        rot_vec = torch.from_numpy(ROT_VECTORS).to(dev)[rot_k]  # (B, N, 2)
        x0 = torch.cat([grid, rot_vec], dim=-1)
    else:
        x0 = grid
    return PuzzleBatch(
        patches=patches,
        x0=x0,
        grid=grid,
        adj=data.adj[None].expand(b, n, n),
        node_mask=torch.ones((b, n), dtype=torch.bool, device=dev),
        patches_dim=data.hw[None].expand(b, 2),
        index=idx.to(torch.int32),
    )
