"""Padded batches — port of the JAX package's ``data/batch.py``.

Every puzzle (or fractured object) is padded to a bucket size with a validity
mask, so shapes are static per bucket:

    PuzzleBatch:   (B, N, …) 2D puzzles  — patches, poses, adjacency mask
    FragmentBatch: (B, P, …) 3D fragments — point clouds, [quat‖trans] poses

``collate_puzzles`` (and ``data/breaking_bad.py:collate_fragments``) build the
batch in numpy (the same bytes as the JAX package's); ``.to`` moves it onto a
torch device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PuzzleBatch(NamedTuple):
    """One padded batch of 2D puzzles (numpy arrays or torch tensors)."""

    patches: np.ndarray  # (B, N, ps, ps, 3) uint8 — converted to float on device
    x0: np.ndarray       # (B, N, C) pose targets; C=2 (pos) or 4 (pos+rotvec)
    grid: np.ndarray     # (B, N, 2) anchor grid positions
    adj: np.ndarray      # (B, N, N) bool attention mask (topology ∧ validity)
    node_mask: np.ndarray  # (B, N) bool
    patches_dim: np.ndarray  # (B, 2) int32 (H, W) per puzzle
    index: np.ndarray    # (B,) int32 sample ids

    def to(self, device: torch.device | str) -> "PuzzleBatch":
        """Same batch as torch tensors on ``device``."""
        return PuzzleBatch(*[torch.as_tensor(np.asarray(a)).to(device) for a in self])


class FragmentBatch(NamedTuple):
    """One padded batch of 3D fractured objects (numpy arrays or torch tensors)."""

    pcds: np.ndarray      # (B, P, n_points, 3) float32, part point clouds
    x0: np.ndarray        # (B, P, 7) [quat(wxyz) ‖ trans]
    adj: np.ndarray       # (B, P, P) bool
    node_mask: np.ndarray  # (B, P) bool — the reference's `part_valids`
    category: np.ndarray  # (B,) int32 category id
    index: np.ndarray     # (B,) int32

    def to(self, device: torch.device | str) -> "FragmentBatch":
        """Same batch as torch tensors on ``device``."""
        return FragmentBatch(*[torch.as_tensor(np.asarray(a)).to(device) for a in self])


def collate_puzzles(samples: list[dict], n_max: int, adj_template: np.ndarray | None = None) -> PuzzleBatch:
    """Pad a list of make_puzzle() dicts (+ optional per-sample 'adj') to N_max.

    If `adj_template` (N_max, N_max) is given it is used for every sample;
    otherwise per-sample 'adj' or fully-connected.
    """
    b = len(samples)
    ps = samples[0]["patches"].shape[1]
    c = samples[0]["x0"].shape[-1]
    patches = np.zeros((b, n_max, ps, ps, 3), dtype=np.uint8)
    x0 = np.zeros((b, n_max, c), dtype=np.float32)
    grid = np.zeros((b, n_max, 2), dtype=np.float32)
    adj = np.zeros((b, n_max, n_max), dtype=bool)
    node_mask = np.zeros((b, n_max), dtype=bool)
    dims = np.zeros((b, 2), dtype=np.int32)
    index = np.zeros((b,), dtype=np.int32)
    for i, s in enumerate(samples):
        n = s["patches"].shape[0]
        p_f = s["patches"]
        patches[i, :n] = (
            p_f if p_f.dtype == np.uint8 else np.clip(p_f * 255.0 + 0.5, 0, 255).astype(np.uint8)
        )
        x0[i, :n] = s["x0"]
        grid[i, :n] = s["grid"]
        node_mask[i, :n] = True
        if adj_template is not None:
            adj[i] = adj_template
        elif "adj" in s:
            adj[i, :n, :n] = s["adj"]
        else:
            adj[i, :n, :n] = True
        adj[i] &= node_mask[i][:, None] & node_mask[i][None, :]
        dims[i] = s.get("patches_dim", (0, 0))
        index[i] = s.get("index", i)
    return PuzzleBatch(patches, x0, grid, adj, node_mask, dims, index)
