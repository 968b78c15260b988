"""Device-resident puzzle corpora and the train step over them — port of the
JAX package's ``train/device_data.py``.

The whole corpus is patchified on the host once and parked on the device as
uint8; each batch is gathered on the device. A corpus holds puzzles of one
size (``DevicePuzzleData``) or of several, padded to the largest
(``DeviceMixedPuzzleData``, the reference's random-size 6/8/10/12 training).
Rotation follows the host conventions of ``data/patchify.py``: pixels rotated
k·90° counter-clockwise, pose target ``ROT_VECTORS[k]`` appended. The JAX
package draws k inside the gather from a JAX key; torch cannot reproduce that
draw, so here the caller passes ``rot_k`` (``make_device_train_step`` draws
it on the device from the train state's generator). One expander per puzzle
size, shared by all its samples, is the reference's ``unique_graph`` mode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.batch import PuzzleBatch
from ..data.expander import expander_mask
from ..data.patchify import ROT_VECTORS, grid_positions, patchify
from ..utils.device import resolve_device
from .train_state import TrainState, apply_update, global_norm, gradients, zero_grads


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


def size_topologies(sizes: list[tuple[int, int]], degree: str | int = -1,
                    seed: int = 0) -> dict[tuple[int, int], np.ndarray]:
    """One (n, n) bool topology per puzzle size (h, w): fully connected for
    ``degree=-1``, else an expander, drawn size after size from
    ``np.random.default_rng(seed)`` as the JAX package's corpus functions draw them."""
    rng = np.random.default_rng(seed)
    out = {}
    for h, w in sizes:
        n = h * w
        if degree in (-1, "-1"):
            out[(h, w)] = np.ones((n, n), dtype=bool)
        else:
            out[(h, w)] = expander_mask(n, degree if isinstance(degree, str) else int(degree), rng)
    return out


def _patchified(image, h: int, w: int, patch_size: int) -> np.ndarray:
    p = patchify(np.asarray(image, np.float32), h, w, patch_size)
    return np.clip(p * 255.0 + 0.5, 0, 255).astype(np.uint8)


def build_device_data(
    images,
    hw: tuple[int, int],
    n_samples: int,
    patch_size: int = 32,
    degree: str | int = -1,
    seed: int = 0,
    device: torch.device | str = "cuda",
    topology: np.ndarray | None = None,
) -> DevicePuzzleData:
    """Patchify ``n_samples`` images on the host once and move the corpus to
    ``device``.

    ``images[i]`` is a float32 [0, 1] image of shape
    (hw[0]·patch_size, hw[1]·patch_size, 3). The shared topology is
    ``topology`` when given, else ``size_topologies([hw], degree, seed)``."""
    device = resolve_device(device)
    h, w = hw
    n = h * w
    out = np.empty((n_samples, n, patch_size, patch_size, 3), dtype=np.uint8)
    for i in range(n_samples):
        out[i] = _patchified(images[i], h, w, patch_size)
    adj = topology if topology is not None else size_topologies([hw], degree, seed)[hw]
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


class DeviceMixedPuzzleData(NamedTuple):
    """A corpus of puzzles of several sizes on one device, padded to N_max.

    Each sample keeps its own grid, topology and node mask, so one batch shape
    covers every size."""

    patches: torch.Tensor    # (S, N_max, ps, ps, 3) uint8, zero on padding
    grid: torch.Tensor       # (S, N_max, 2) float32, zero on padding
    adj: torch.Tensor        # (S, N_max, N_max) bool
    node_mask: torch.Tensor  # (S, N_max) bool
    hw: torch.Tensor         # (S, 2) int32

    @property
    def n_samples(self) -> int:
        return self.patches.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.patches.shape[1]


def build_device_data_mixed(
    image_factory,
    sizes: list[tuple[int, int]],
    n_samples: int,
    patch_size: int = 32,
    degree: str | int = -1,
    seed: int = 0,
    device: torch.device | str = "cuda",
    topologies: dict[tuple[int, int], np.ndarray] | None = None,
) -> DeviceMixedPuzzleData:
    """A mixed-size corpus: sample i has size ``sizes[i % len(sizes)]``.

    ``image_factory(size_hw, i)`` is a float32 [0, 1] image of shape
    (h·patch_size, w·patch_size, 3). Every sample of one size shares that
    size's topology: ``topologies[(h, w)]`` when given, else
    ``size_topologies(sizes, degree, seed)``. Patches, grid, topology and mask
    are zero on padding."""
    device = resolve_device(device)
    n_max = max(h * w for h, w in sizes)
    topologies = topologies if topologies is not None else size_topologies(sizes, degree, seed)
    patches = np.zeros((n_samples, n_max, patch_size, patch_size, 3), dtype=np.uint8)
    grid = np.zeros((n_samples, n_max, 2), dtype=np.float32)
    adj = np.zeros((n_samples, n_max, n_max), dtype=bool)
    mask = np.zeros((n_samples, n_max), dtype=bool)
    hw = np.zeros((n_samples, 2), dtype=np.int32)
    for i in range(n_samples):
        h, w = sizes[i % len(sizes)]
        n = h * w
        patches[i, :n] = _patchified(image_factory((h * patch_size, w * patch_size), i), h, w, patch_size)
        grid[i, :n] = grid_positions(h, w)
        adj[i, :n, :n] = topologies[(h, w)]
        mask[i, :n] = True
        hw[i] = (h, w)
    return DeviceMixedPuzzleData(*(torch.from_numpy(a).to(device) for a in (patches, grid, adj, mask, hw)))


def gather_batch_mixed(data: DeviceMixedPuzzleData, idx: torch.Tensor,
                       rot_k: torch.Tensor | None = None) -> PuzzleBatch:
    """``gather_batch`` for a mixed-size corpus: padding nodes keep rotation
    0, zero patches and a zero target, and are masked."""
    dev = data.patches.device
    idx = idx.to(dev)
    b, n = idx.shape[0], data.n_nodes
    patches = data.patches[idx]
    grid = data.grid[idx]
    node_mask = data.node_mask[idx]
    if rot_k is not None:
        rot_k = torch.where(node_mask, rot_k.to(device=dev, dtype=torch.int64), 0)
        views = torch.stack([torch.rot90(patches, k, dims=(2, 3)) for k in range(4)])
        patches = views[rot_k, torch.arange(b, device=dev)[:, None], torch.arange(n, device=dev)[None, :]]
        rot_vec = torch.where(node_mask[..., None], torch.from_numpy(ROT_VECTORS).to(dev)[rot_k], 0.0)
        x0 = torch.cat([grid, rot_vec], dim=-1)
    else:
        x0 = grid
    return PuzzleBatch(
        patches=patches,
        x0=x0,
        grid=grid,
        adj=data.adj[idx],
        node_mask=node_mask,
        patches_dim=data.hw[idx],
        index=idx.to(torch.int32),
    )


def make_device_train_step(
    loss_fn,
    optimizer,
    rotation: bool,
    max_grad_norm: float | None = 10.0,
    ema_decay: float | None = None,
):
    """The train step over a device-resident corpus:
    ``step(state, data, batch_size, draws=None) → (state, aux)``.

    It draws the sample indices, then (with ``rotation``) one k·90° rotation
    per piece, from the state's generator on the corpus's device, gathers the
    batch there, and calls ``loss_fn(batch, generator, **draws)``, which draws
    the rest. ``draws`` may hold ``idx`` and ``rot_k`` in their place and the
    loss's own (``t_graph``, ``noise``, ``cf_keep``): the tests feed the JAX
    package's. The clip is the JAX step's as it is: the global norm + 1e-9,
    with no zeroing of non-finite entries (``train_state.make_train_step``
    has both); ``grad_norm`` is the norm after the clip. Then the optimizer
    and the debiased EMA, as in ``train_state.apply_update``."""

    def step(state: TrainState, data, batch_size: int, draws: dict | None = None):
        draws = dict(draws or {})
        gen, dev = state.generator, data.patches.device
        idx = draws.pop("idx", None)
        if idx is None:
            idx = torch.randint(0, data.n_samples, (batch_size,), generator=gen, device=dev)
        rot_k = draws.pop("rot_k", None)
        if rotation and rot_k is None:
            rot_k = torch.randint(0, 4, (batch_size, data.n_nodes), generator=gen, device=dev)
        gather = gather_batch_mixed if isinstance(data, DeviceMixedPuzzleData) else gather_batch
        batch = gather(data, idx, rot_k if rotation else None)
        zero_grads(state.params)
        loss, aux = loss_fn(batch, gen, **draws)
        loss.backward()
        aux = {k: torch.as_tensor(v).detach() for k, v in aux.items()}
        grads = gradients(state.params)
        if max_grad_norm is not None:
            with torch.no_grad():
                scale = torch.clamp(max_grad_norm / (global_norm(grads) + 1e-9), max=1.0)
                torch._foreach_mul_(grads, scale)
        return apply_update(state, optimizer, ema_decay, aux)

    return step
