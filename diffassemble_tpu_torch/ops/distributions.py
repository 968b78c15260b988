"""Distributions on SE(3)/SO(3) and two-sample tests — port of the JAX
package's ``ops/distributions.py``.

- ``AffineT``: an (rotation, shift) pair;
- ``igso3xr3_sample``: IGSO3 rotation × Gaussian shift (``ops/igso3.py``);
- ``bingham_sample``: antipodally-symmetric quaternions, by rejection from
  the angular central Gaussian envelope;
- ``mmd_rbf``, ``mmd_rotation``: kernel two-sample tests.

Sampling draws from an explicit ``torch.Generator`` where the JAX package
splits a PRNG key: the same law, other numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .igso3 import igso3_sample
from .knn import pairwise_sqdist
from .so3 import _mm, quaternion_to_matrix


class AffineT(NamedTuple):
    """SE(3) element: rotation matrices (..., 3, 3) + shift (..., 3)."""

    rot: torch.Tensor
    shift: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.shift.shape[:-1]

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ij,...nj->...ni", self.rot, points) + self.shift[..., None, :]

    def compose(self, other: "AffineT") -> "AffineT":
        return AffineT(rot=_mm(self.rot, other.rot),
                       shift=torch.einsum("...ij,...j->...i", self.rot, other.shift) + self.shift)

    def inverse(self) -> "AffineT":
        rinv = self.rot.transpose(-1, -2)
        return AffineT(rot=rinv, shift=-torch.einsum("...ij,...j->...i", rinv, self.shift))


def igso3xr3_sample(generator: torch.Generator | None, inv_cdf: torch.Tensor, t: torch.Tensor,
                    shift_scale: float = 1.0, mean: AffineT | None = None) -> AffineT:
    """Sample from IGSO3(eps_t) × N(0, shift_scale²): the SE(3) product
    distribution; the rotation's draws, then the shift's, from ``generator``."""
    rot = igso3_sample(inv_cdf, t, generator)
    shift = torch.randn((*t.shape, 3), generator=generator, device=inv_cdf.device) * shift_scale
    if mean is not None:
        rot = _mm(mean.rot, rot)
        shift = shift + mean.shift
    return AffineT(rot=rot, shift=shift)


def bingham_sample(generator: torch.Generator | None, A: torch.Tensor, n: int, max_tries: int = 32) -> torch.Tensor:
    """Sample n unit quaternions from Bingham(A) (A: (4, 4) symmetric) by
    rejection from the angular central Gaussian envelope.

    Static-shape rejection: draws max_tries candidates per sample and picks the
    first accepted (the best candidate if none is)."""
    A = torch.as_tensor(A, dtype=torch.float32)
    eye = torch.eye(4, device=A.device)
    evals = torch.linalg.eigvalsh(A)  # ascending
    A = A - evals[-1] * eye  # shift so max eigenvalue is 0 (log-density ≤ 0)
    b = 1.0
    omega = eye - 2.0 * A / b
    # ACG proposals: y ~ N(0, omega^{-1}), normalized
    chol = torch.linalg.cholesky(torch.linalg.inv(omega) + 1e-8 * eye)
    z = torch.randn((n, max_tries, 4), generator=generator, device=A.device)
    y = z @ chol.T
    y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-8)
    log_f = torch.einsum("nti,ij,ntj->nt", y, A, y)
    log_g = -2.0 * torch.log(torch.einsum("nti,ij,ntj->nt", y, omega, y))
    log_ratio = log_f - log_g - (b / 2.0 - 1.0 + torch.log(torch.tensor(2.0)))
    u = torch.log(torch.rand((n, max_tries), generator=generator, device=A.device) + 1e-30)
    accept = u < log_ratio
    pick = torch.where(accept.any(dim=1), accept.int().argmax(dim=1), log_ratio.argmax(dim=1))
    return torch.take_along_dim(y, pick[:, None, None], dim=1)[:, 0]


def mmd_rbf(x: torch.Tensor, y: torch.Tensor, bandwidth: float | None = None) -> torch.Tensor:
    """Unbiased MMD² with an RBF kernel; bandwidth defaults to the median
    heuristic over the pooled pairwise distances (of an even count, the mean
    of the two middle values, as ``jnp.median`` takes it)."""
    dxx, dyy, dxy = pairwise_sqdist(x, x), pairwise_sqdist(y, y), pairwise_sqdist(x, y)
    if bandwidth is None:
        pooled = torch.cat([dxx.flatten(), dyy.flatten(), dxy.flatten()]).sort().values
        mid = pooled.numel() // 2
        median = pooled[mid] if pooled.numel() % 2 else (pooled[mid - 1] + pooled[mid]) / 2
        bandwidth = torch.clamp(median, min=1e-8)
    k = lambda d: torch.exp(-d / bandwidth)  # noqa: E731
    n, m = x.shape[0], y.shape[0]
    kxx = (k(dxx).sum() - n) / (n * (n - 1))
    kyy = (k(dyy).sum() - m) / (m * (m - 1))
    return kxx + kyy - 2 * k(dxy).mean()


def mmd_rotation(q1: torch.Tensor, q2: torch.Tensor, bandwidth: float | None = None) -> torch.Tensor:
    """MMD over rotations, embedding quaternions as flattened matrices so the
    ±q ambiguity vanishes."""
    r1 = quaternion_to_matrix(q1).reshape(q1.shape[0], 9)
    r2 = quaternion_to_matrix(q2).reshape(q2.shape[0], 9)
    return mmd_rbf(r1, r2, bandwidth)
