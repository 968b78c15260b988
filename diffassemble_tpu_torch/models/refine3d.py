"""Post-sampler SE(3) pose refinement by batched multiview trimmed ICP — port
of the JAX package's ``models/refine3d.py``.

All fragments of an object are registered against each other at once,
starting from the sampler's poses. Each outer iteration:

- matches every point to its nearest point of the union of the object's
  other valid parts (only fracture-wall points with ``point_w``);
- weights each match by a Gaussian of its distance (σ annealed from
  ``sigma0`` to ``sigma1``), keeps each part's closest ``trim`` share, and
  gates it by the normals' compatibility |n_u·n_v|⁴;
- solves one damped Gauss-Newton step per part (a 6×6 system of
  point-to-plane rows plus ``p2p_mix`` of point-to-point rows, with an
  ``anchor`` prior pulling the cumulative deviation from the sampler's pose
  back), halved (Jacobi relaxation: all parts move at once against the
  others' frozen poses) and its rotation clipped at ``max_rot_step``.

The JAX package's ``lax.scan`` over the iterations is a Python loop here.
Products run in full f32 (``f32_matmuls``), as the JAX package's at
``Precision.HIGHEST``.

Pose convention: the stored quaternion rotates the centred assembled part
into its input cloud, local = R (assembled − t); the assembly is x = Rᵀ
local + t (row form ``local @ R``), and a world-frame update dr makes
R ← R drᵀ.

The normals are the eigenvectors of each point's neighbourhood covariance
with the smallest eigenvalue (``torch.linalg.eigh`` on the host: ascending
eigenvalues, eigenvectors in columns, as ``jnp.linalg.eigh``). An
eigenvector's sign is arbitrary, and the two packages' solvers do not agree
on it (on a CPU about a tenth of the port's normals point the other way
from the JAX package's), but nothing downstream sees it: the gate takes
|n_u·n_v|, a point-to-plane row [u×n ; n] and its right-hand side −n·(u − v)
flip together, so the normal equations hold products of two of them. The
parity test holds the normals to the JAX package's up to sign and the
refined poses to its poses (within 6.6e-7 after 20 iterations).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import so3
from ..ops.knn import knn_indices, pairwise_sqdist
from ..ops.so3 import f32_matmuls

_FAR = 1.0e6  # squared distance given to masked correspondence targets


class RefineResult(NamedTuple):
    quat: torch.Tensor  # (B, P, 4) refined rotations (wxyz, unit)
    trans: torch.Tensor  # (B, P, 3) refined translations
    resid0: torch.Tensor  # (B,) weighted mean nearest distance before
    resid1: torch.Tensor  # (B,) weighted mean nearest distance after


def _pca_normals(pts: torch.Tensor, k: int = 10) -> torch.Tensor:
    """(B, P, S, 3) local clouds → (B, P, S, 3) unit normals by k-NN PCA (sign arbitrary)."""
    b, p = pts.shape[:2]
    idx = knn_indices(pts, k)  # (B, P, S, k)
    bi = torch.arange(b, device=pts.device)[:, None, None, None]
    pi = torch.arange(p, device=pts.device)[None, :, None, None]
    nb = pts[bi, pi, idx]  # (B, P, S, k, 3)
    nb = nb - nb.mean(dim=-2, keepdim=True)
    with f32_matmuls():
        cov = torch.einsum("...ki,...kj->...ij", nb, nb)
    # on the host: cuSOLVER's batched syev refuses a batch of this size
    # (16 objects × 8 parts × 256 points, CUSOLVER_STATUS_INVALID_VALUE on an
    # H100); the 3×3 solves cost little there, and LAPACK is the JAX package's
    n = torch.linalg.eigh(cov.cpu()).eigenvectors[..., :, 0].to(pts.device)
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)


def _correspond(x, n_world, node_mask, sigma, trim: float, point_w=None):
    """Nearest-other-part matches with frozen robust weights.

    x (B, P, S, 3) world points, n_world their normals, point_w an optional
    (B, P, S) weight in [0, 1] (fracture-wall membership: points of weight 0
    neither source nor receive matches). Returns (targets, target normals,
    weights (B, P, S), the weighted mean nearest distance (B,))."""
    b, p, s, _ = x.shape
    flat = x.reshape(b, p * s, 3)
    flat_n = n_world.reshape(b, p * s, 3)
    pid = torch.arange(p, device=x.device)
    tgt_ok = node_mask[:, None, :] & (pid[None, :, None] != pid[None, None, :])
    tgt_ok = tgt_ok.repeat_interleave(s, dim=-1)  # (B, P, P·S)
    if point_w is not None:
        tgt_ok = tgt_ok & (point_w.reshape(b, 1, p * s) > 0)
    d2 = pairwise_sqdist(x, flat[:, None])  # (B, P, S, P·S)
    d2 = torch.where(tgt_ok[:, :, None, :], d2, _FAR)
    dmin, idx = d2.min(dim=-1)  # (B, P, S), ties to the lower index
    wg = torch.exp(-dmin / (sigma * sigma))
    kth_at = max(int(trim * s) - 1, 0)
    # with point_w, trim within the wall population: other rows rank last
    rank_d = dmin if point_w is None else torch.where(point_w > 0, dmin, _FAR)
    kth = torch.sort(rank_d, dim=-1).values[..., kth_at]
    wt = (rank_d <= kth[..., None]).to(x.dtype)
    rows = torch.arange(b, device=x.device)[:, None]
    tgt = flat[rows, idx.reshape(b, p * s)].reshape(b, p, s, 3)
    tgt_n = flat_n[rows, idx.reshape(b, p * s)].reshape(b, p, s, 3)
    ncomp = torch.abs((n_world * tgt_n).sum(-1)) ** 4
    w = wg * wt * ncomp * node_mask.to(x.dtype)[..., None]
    if point_w is not None:
        w = w * point_w
    wsum = w.sum(dim=(1, 2)) + 1e-9
    diag = (w * torch.sqrt(dmin + 1e-12)).sum(dim=(1, 2)) / wsum
    return tgt, tgt_n, w, diag


@torch.no_grad()
def refine_poses(
    pts: torch.Tensor,
    node_mask: torch.Tensor,
    quat: torch.Tensor,
    trans: torch.Tensor,
    *,
    steps: int = 40,
    sigma0: float = 0.2,
    sigma1: float = 0.04,
    trim: float = 0.25,
    p2p_mix: float = 0.1,
    damping: float = 1e-3,
    anchor: float = 0.05,
    step_scale: float = 0.5,
    max_rot_step: float = 0.15,
    n_sub: int = 256,
    normals_k: int = 10,
    point_w: torch.Tensor | None = None,
) -> RefineResult:
    """Refine per-part SE(3) poses (``pts`` (B, P, N, 3) local clouds,
    ``node_mask`` (B, P) bool, ``quat`` (B, P, 4), ``trans`` (B, P, 3)) by
    ``steps`` iterations of multiview trimmed ICP on each part's first
    ``n_sub`` points (see the module docstring)."""
    pts, node_mask, quat, trans = pts.float()[:, :, :n_sub], node_mask.bool(), quat.float(), trans.float()
    if point_w is not None:
        point_w = point_w[:, :, :n_sub].to(pts.dtype)
    with f32_matmuls():
        normals = _pca_normals(pts, normals_k)
        q0 = quat / (torch.linalg.vector_norm(quat, dim=-1, keepdim=True) + 1e-9)
        r_init = so3.quaternion_to_matrix(q0)
        eye6 = torch.eye(6, dtype=pts.dtype, device=pts.device)
        eye3 = torch.eye(3, dtype=pts.dtype, device=pts.device)
        ok = node_mask[..., None].to(pts.dtype)
        r, t = r_init, trans
        for k in range(steps):
            frac = torch.tensor(k, dtype=pts.dtype) / max(steps - 1, 1)
            sigma = sigma0 * (sigma1 / sigma0) ** frac
            x = pts @ r + t[:, :, None, :]  # Rᵀ local + t: the assembly
            tgt, tgt_n, w, _ = _correspond(x, normals @ r, node_mask, sigma.to(pts.device), trim, point_w)
            resid = x - tgt
            # linearised about each part's centroid (its translation): the rows
            # use uc = u − c, so rotation and translation decouple
            uc = x - t[:, :, None, :]
            # point-to-plane rows [uc × n ; n], right-hand side −n·(u − v)
            jpl = torch.cat([torch.linalg.cross(uc, tgt_n, dim=-1), tgt_n], dim=-1)  # (B, P, S, 6)
            rpl = -(resid * tgt_n).sum(-1)
            # point-to-point rows [−[uc]× ; I], right-hand side −(u − v)
            ux = so3.vec2skew(uc)  # (B, P, S, 3, 3)
            jpt = torch.cat([-ux, eye3.expand(ux.shape)], dim=-1)  # (B, P, S, 3, 6)
            a = (torch.einsum("bpsi,bpsj->bpij", w[..., None] * jpl, jpl)
                 + p2p_mix * torch.einsum("bpsai,bpsaj->bpij", w[..., None, None] * jpt, jpt))
            rhs = (torch.einsum("bpsi,bps->bpi", jpl, w * rpl)
                   + p2p_mix * torch.einsum("bpsai,bpsa->bpi", jpt, w[..., None] * -resid))
            wn = w.sum(-1)[..., None, None] + 1e-9
            # the anchor pulls the cumulative deviation from the sampler's pose
            # (world-frame: R_curᵀ = DR R_initᵀ, so DR = R_curᵀ R_init) back to 0
            dev_w = so3.rmat_to_rotvec(so3._mm(r.transpose(-1, -2), r_init))
            dev = torch.cat([dev_w, t - trans], dim=-1)  # (B, P, 6)
            a_n = a / wn + (damping + anchor) * eye6
            rhs_n = rhs / wn[..., 0] - anchor * dev
            delta = step_scale * torch.linalg.solve(a_n, rhs_n[..., None])[..., 0]
            omega, dt = delta[..., :3], delta[..., 3:]
            onorm = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
            omega = omega * torch.clamp(max_rot_step / (onorm + 1e-9), max=1.0)
            dr = so3.rotvec_to_rmat(omega)
            r_new = so3._mm(r, dr.transpose(-1, -2))  # Rᵀ ← dr Rᵀ
            t_new = t + dt
            r = r_new * ok[..., None] + r * (1 - ok[..., None])
            t = t_new * ok + t * (1 - ok)
        _, _, _, resid0 = _correspond(pts @ r_init + trans[:, :, None, :], normals @ r_init, node_mask, sigma1, trim,
                                      point_w)
        _, _, _, resid1 = _correspond(pts @ r + t[:, :, None, :], normals @ r, node_mask, sigma1, trim, point_w)
        return RefineResult(so3.matrix_to_quaternion(r), t, resid0, resid1)
