"""Visualisation — port of the JAX package's ``utils/viz.py``: reassembled
puzzle images, per-step trajectory dumps and the 3D fragment exports.

- ``save_reconstruction``: the prediction beside the ground truth as a PNG
  through PIL, imported when it is called; where PIL is missing, the same
  pixels as an ``.npy`` (``<path>.npy``), as the JAX package writes them.
- ``save_trajectory``: one reconstruction per sampling step.
- ``export_fragment_trajectory`` and ``export_fragments_ply``: the posed part
  clouds of every step as ASCII ``.ply`` (a colour per part) and the whole
  trajectory as one ``.npz``, read by ``viz_scripts/3d/blender_script.py``.
"""

from __future__ import annotations

from pathlib import Path

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


def save_reconstruction(
    path: str | Path,
    patches: np.ndarray,
    pred_pos: np.ndarray,
    gt_pos: np.ndarray,
    patches_dim: tuple[int, int],
    pred_rot: np.ndarray | None = None,
    gt_rot: np.ndarray | None = None,
) -> None:
    """The prediction beside the ground truth, 8 white columns apart: a PNG
    at ``path``, or without PIL the uint8 pixels at ``<path>.npy``."""
    pred = compose_from_positions(patches, pred_pos, patches_dim, pred_rot)
    gt = compose_from_positions(patches, gt_pos, patches_dim, gt_rot)
    gap = np.ones((pred.shape[0], 8, 3), dtype=np.float32)
    img = np.concatenate([pred, gap, gt], axis=1)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        np.save(str(path) + ".npy", arr)
        return
    Image.fromarray(arr).save(str(path))


def save_reconstructions(prefix: str | Path, patches, final: np.ndarray, x0, node_mask, patches_dim,
                         rotation: bool, count: int) -> None:
    """``save_reconstruction`` of the first ``count`` puzzles of a host batch
    (``patches`` (B, N, ps, ps, 3), ``x0`` (B, N, C), ``node_mask`` (B, N),
    ``patches_dim`` (B, 2)) posed by ``final`` (B, N, C), their valid pieces
    only, each at ``<prefix>_p<i>.png``; with ``rotation`` the rotation
    channels turn the pieces."""
    for i in range(min(count, final.shape[0])):
        vm, x0_i = np.asarray(node_mask[i]), np.asarray(x0[i])
        save_reconstruction(f"{prefix}_p{i}.png", np.asarray(patches[i])[vm], final[i][vm, :2], x0_i[vm, :2],
                            tuple(np.asarray(patches_dim[i])), pred_rot=final[i][vm, 2:4] if rotation else None,
                            gt_rot=x0_i[vm, 2:4] if rotation else None)


def save_trajectory(
    out_dir: str | Path,
    patches: np.ndarray,
    trajectory: np.ndarray,
    gt_pos: np.ndarray,
    patches_dim: tuple[int, int],
    name: str = "sample",
) -> None:
    """``save_reconstruction`` of every step of a (S, N, C) ``trajectory`` as
    ``<name>_step<s>.png`` (C ≥ 4: channels 2:4 are the rotation)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for s in range(trajectory.shape[0]):
        pos = trajectory[s][..., :2]
        rot = trajectory[s][..., 2:4] if trajectory.shape[-1] >= 4 else None
        save_reconstruction(out_dir / f"{name}_step{s:03d}.png", patches, pos, gt_pos, patches_dim, rot)


def export_fragment_trajectory(
    out_dir: str | Path,
    pcds: np.ndarray,
    trajectory: np.ndarray,
    valids: np.ndarray,
    name: str = "assembly",
) -> None:
    """``<name>_traj.npz`` (the (S, P, C) pose ``trajectory``, the (P, N, 3)
    clouds and the (P,) valid mask) and one ``<name>_step<s>.ply`` per step."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / f"{name}_traj.npz", trajectory=trajectory, pcds=pcds, valids=valids)
    for s in range(trajectory.shape[0]):
        export_fragments_ply(out_dir / f"{name}_step{s:03d}.ply", pcds, trajectory[s, :, 4:7],
                             trajectory[s, :, :4], valids)


_PART_COLORS = np.asarray([[228, 26, 28], [55, 126, 184], [77, 175, 74], [152, 78, 163],
                           [255, 127, 0], [255, 255, 51], [166, 86, 40], [247, 129, 191]])


def export_fragments_ply(
    path: str | Path,
    pcds: np.ndarray,
    trans: np.ndarray,
    quats: np.ndarray,
    valids: np.ndarray,
) -> None:
    """The valid parts' (P, N, 3) clouds, each rotated by its wxyz quaternion
    and moved by its translation, as one ASCII ``.ply`` with a colour per part."""
    import torch

    from ..ops.so3 import quaternion_to_matrix

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pts_all, col_all = [], []
    for p in range(pcds.shape[0]):
        if not valids[p]:
            continue
        r = quaternion_to_matrix(torch.as_tensor(np.asarray(quats[p], dtype=np.float32))).numpy()
        pts = pcds[p] @ r.T + trans[p]
        pts_all.append(pts)
        col_all.append(np.tile(_PART_COLORS[p % len(_PART_COLORS)], (len(pts), 1)))
    pts = np.concatenate(pts_all)
    cols = np.concatenate(col_all)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for pt, c in zip(pts, cols):
            f.write(f"{pt[0]:.5f} {pt[1]:.5f} {pt[2]:.5f} {c[0]} {c[1]} {c[2]}\n")
