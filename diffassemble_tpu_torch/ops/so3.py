"""SO(3) toolkit — port of the JAX package's ``ops/so3.py``: rotation
representations and Lie-group operations, branchless.

Quaternions are scalar-first (w, x, y, z). Every function broadcasts over
leading dimensions. The JAX package pins its 3×3 rotation products to full
f32 precision (``Precision.HIGHEST``); here they are written as elementwise
products and sums (``_mm``), which are full f32 on every device whatever the
process's TF32 setting, and take no global switch that could leak into the
bf16 denoiser. ``f32_matmuls`` is the scope for the larger f32 products of
the 3D path (kNN distances, the relative-pose head).
"""

from __future__ import annotations

import contextlib
import math

import torch

_EPS = 1e-8


@contextlib.contextmanager
def f32_matmuls():
    """Matmuls and convolutions inside run in full f32 (TF32 off), and the
    process's own setting is restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _safe_norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Norm with a finite gradient at 0."""
    return torch.sqrt((v * v).sum(dim=dim, keepdim=keepdim) + _EPS**2)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) × (..., 3, 3) in full f32, as elementwise products."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


# ---------------------------------------------------------------------------
# quaternion <-> matrix
# ---------------------------------------------------------------------------

def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz unit quaternion → (..., 3, 3) rotation matrix."""
    q = q / _safe_norm(q, keepdim=True)
    w, x, y, z = q.unbind(-1)
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with a zero (not NaN) gradient at x ≤ 0."""
    pos = x > 1e-12
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))), torch.zeros_like(x))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix → (..., 4) wxyz quaternion, branchless
    (Shepperd): all four candidate quaternions, the one keyed by the largest
    of the (1 ± trace) combinations kept."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )
    cands = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    cands = cands / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    # the first of equal maxima, as jnp.argmax; the others are cut before the sum
    best = torch.nn.functional.one_hot(q_abs.argmax(-1), 4).bool()
    q = torch.where(best[..., None], cands, torch.zeros_like(cands)).sum(-2)
    return q / _safe_norm(q, keepdim=True)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so w >= 0 (q and -q encode the same rotation)."""
    return torch.where(q[..., :1] < 0, -q, q)


# ---------------------------------------------------------------------------
# axis-angle / skew
# ---------------------------------------------------------------------------

def vec2skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3) skew matrix K with K@p = v×p."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    rows = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return rows.reshape(*v.shape[:-1], 3, 3)


def skew2vec(k: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew → (..., 3) vector."""
    return torch.stack([k[..., 2, 1], k[..., 0, 2], k[..., 1, 0]], dim=-1)


def aa_to_rmat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: unit axis (..., 3) + angle (...,) → (..., 3, 3)."""
    k = vec2skew(axis)
    a = angle[..., None, None]
    return _eye_like(k) + torch.sin(a) * k + (1.0 - torch.cos(a)) * _mm(k, k)


def rotvec_to_rmat(v: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation vector (..., 3) with |v| = angle → matrix, by
    the closed-form Rodrigues formula with series of sin(θ)/θ and
    (1 − cos θ)/θ² near θ = 0."""
    theta2 = (v * v).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS**2))
    small = theta2 < 1e-8
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS**2))
    k = vec2skew(v)
    return _eye_like(k) + sinc[..., None, None] * k + cosc[..., None, None] * _mm(k, k)


def quaternion_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz → (..., 3) rotation vector (axis · angle), angle in [0, π]."""
    q = standardize_quaternion(q / _safe_norm(q, keepdim=True))
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = _safe_norm(v)
    angle = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(vnorm < 1e-6, 2.0 + angle**2 / 12.0, angle / torch.clamp(vnorm, min=_EPS))
    return v * scale[..., None]


def rmat_to_rotvec(m: torch.Tensor) -> torch.Tensor:
    """Matrix log as a rotation vector (through the quaternion)."""
    return quaternion_to_rotvec(matrix_to_quaternion(m))


def log_rmat(m: torch.Tensor) -> torch.Tensor:
    """Matrix logarithm of a rotation (..., 3, 3) → skew (..., 3, 3), stable at 180°."""
    return vec2skew(rmat_to_rotvec(m))


def so3_scale(m: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Fractional rotation power R^s = exp(s · log R); ``scalars`` (...,)."""
    return rotvec_to_rmat(rmat_to_rotvec(m) * scalars[..., None])


def so3_lerp(r0: torch.Tensor, r1: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Geodesic interpolation R0 → R1 by fraction w."""
    return _mm(r0, so3_scale(_mm(r0.transpose(-1, -2), r1), w))


# ---------------------------------------------------------------------------
# metrics helpers
# ---------------------------------------------------------------------------

def geodesic_distance_rmat(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotations (..., 3, 3) → (...,) radians."""
    rel = _mm(r1.transpose(-1, -2), r2)
    tr = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    return torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0 + 1e-6, 1.0 - 1e-6))


def quaternion_to_euler(q: torch.Tensor, order: str = "zyx", degrees: bool = True) -> torch.Tensor:
    """Quaternion → euler angles (the reference's ``qeuler``), stacked as
    (x, y, z) whatever the order."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    q0, q1, q2, q3 = q.unbind(-1)
    if order == "zyx":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = torch.asin(torch.clamp(2 * (q0 * q2 - q1 * q3), -1.0, 1.0))
        z = torch.atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    elif order == "xyz":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = torch.asin(torch.clamp(2 * (q1 * q3 + q0 * q2), -1.0, 1.0))
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    else:
        raise NotImplementedError(f"euler order {order}")
    e = torch.stack([x, y, z], dim=-1)
    return e * (180.0 / math.pi) if degrees else e


# ---------------------------------------------------------------------------
# 6-DoF (Gram-Schmidt) rotation representation
# ---------------------------------------------------------------------------

def sixdof_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) two 3-vectors → rotation matrix by Gram-Schmidt; they become
    the first two columns of R."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / _safe_norm(a1, keepdim=True)
    b2 = a2 - (a2 * b1).sum(-1, keepdim=True) * b1
    b2 = b2 / _safe_norm(b2, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_sixdof(m: torch.Tensor) -> torch.Tensor:
    """First two columns of R, flattened to (..., 6)."""
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def orthogonalise(m: torch.Tensor) -> torch.Tensor:
    """SVD-snap a near-rotation matrix to SO(3)."""
    u, _, vt = torch.linalg.svd(m)
    det = torch.linalg.det(_mm(u, vt))
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return _mm(u * d[..., None, :], vt)


def random_quaternion(generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
    """Uniform random unit quaternions (..., 4), wxyz, from ``generator``, on its device."""
    q = torch.randn((*shape, 4), generator=generator, device=generator.device)
    return q / _safe_norm(q, keepdim=True)
