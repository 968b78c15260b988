"""Isotropic Gaussian distribution on SO(3) (IGSO3) — port of the JAX
package's ``ops/igso3.py``.

The eps values that ever occur are sqrt(1 − ᾱ_t) for the schedule's T steps,
so one inverse-CDF table of shape (T, Q) is computed once on the host in
float64 (``build_igso3_inverse_cdf``; ``igso3_angle_pdf`` and it are numpy,
copied from the JAX package unchanged). Sampling is then a gather and a lerp
per part: the angle at quantile u of the row of step t, about a uniformly
random axis (a normalised normal draw), ``aa_to_rmat(axis, angle)``.

u and the axes are drawn from a ``torch.Generator`` on the table's device, or
given (the tests feed the JAX package's draws).
"""

from __future__ import annotations

import numpy as np
import torch

from .so3 import aa_to_rmat


def igso3_angle_pdf(angles: np.ndarray, eps: np.ndarray) -> np.ndarray:
    """Density over the rotation *angle* in [0, π] including the Haar factor
    (1-cos t)/π, for concentration eps (stddev-like). Host-side float64.

    Truncated closed-form series as in reference distributions.py:533-552.
    ``angles`` (L,) and ``eps`` (E,) broadcast to (L, E).
    """
    t = np.asarray(angles, dtype=np.float64)[:, None]
    var = np.asarray(eps, dtype=np.float64)[None, :] ** 2
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        series = (
            np.sqrt(np.pi)
            * var ** (-1.5)
            * np.exp(var / 4)
            * np.exp(-((t / 2) ** 2) / var)
            * (
                t
                - np.exp(-(np.pi**2) / var)
                * (
                    (t - 2 * np.pi) * np.exp(np.pi * t / var)
                    + (t + 2 * np.pi) * np.exp(-np.pi * t / var)
                )
            )
            / (2 * np.sin(t / 2))
        )
    series = np.where(np.isfinite(series), series, 0.0)
    haar = (1.0 - np.cos(t)) / np.pi
    pdf = series * haar
    pdf[t[:, 0] == 0.0, :] = 0.0
    return np.maximum(pdf, 0.0)


def build_igso3_inverse_cdf(
    eps_values: np.ndarray, n_locs: int = 1024, n_quantiles: int = 256
) -> np.ndarray:
    """Precompute angle = F⁻¹(u) tables.

    Returns (E, Q) float32: for each eps, the angle at quantiles
    u = linspace(0, 1, Q). Sample locations are packed near 0 as
    π·linspace(0,1,L)³ like the reference (:495).
    """
    eps_values = np.atleast_1d(np.asarray(eps_values, dtype=np.float64))
    locs = np.pi * np.linspace(0.0, 1.0, n_locs) ** 3.0  # (L,)
    pdf = igso3_angle_pdf(locs, eps_values)  # (L, E)
    # trapezoidal CDF
    dl = np.diff(locs)[:, None]
    cdf = np.concatenate(
        [np.zeros((1, len(eps_values))), np.cumsum(dl * (pdf[:-1] + pdf[1:]) / 2, axis=0)],
        axis=0,
    )  # (L, E)
    total = cdf[-1:, :]
    # degenerate series (shouldn't happen in-range) → fall back to uniform Haar
    haar_pdf = (1.0 - np.cos(locs)) / np.pi
    haar_cdf = np.concatenate(
        [[0.0], np.cumsum(np.diff(locs) * (haar_pdf[:-1] + haar_pdf[1:]) / 2)]
    )
    haar_cdf = haar_cdf / haar_cdf[-1]
    bad = (total < 1e-12)[0]
    cdf = np.where(bad[None, :], haar_cdf[:, None], cdf / np.maximum(total, 1e-300))

    qs = np.linspace(0.0, 1.0, n_quantiles)
    table = np.empty((len(eps_values), n_quantiles), dtype=np.float32)
    for e in range(len(eps_values)):
        # cdf is monotone in locs; invert by interpolation
        table[e] = np.interp(qs, cdf[:, e], locs).astype(np.float32)
    return table


def igso3_sample_angle(inv_cdf: torch.Tensor, t: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Rotation angles (...,) at quantiles ``u`` (...,) in [0, 1) of the rows
    ``t`` (integer (...,)) of ``inv_cdf`` (T, Q), with linear interpolation
    between the Q quantile knots."""
    q = inv_cdf.shape[1]
    pos = u * (q - 1)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, q - 2)
    w = pos - i0.to(pos.dtype)
    rows = inv_cdf[t.long()]  # (..., Q)
    a0 = torch.gather(rows, -1, i0[..., None])[..., 0]
    a1 = torch.gather(rows, -1, (i0 + 1)[..., None])[..., 0]
    return a0 * (1 - w) + a1 * w


def igso3_draws(shape: tuple[int, ...], generator: torch.Generator | None,
                device: torch.device | str) -> tuple[torch.Tensor, torch.Tensor]:
    """The sampler's draws for ``shape`` rotations, in its order: u (shape)
    uniform in [0, 1) and the axes (*shape, 3) standard normal."""
    u = torch.rand(shape, generator=generator, device=device)
    axes = torch.randn((*shape, 3), generator=generator, device=device)
    return u, axes


def igso3_sample(inv_cdf: torch.Tensor, t: torch.Tensor, generator: torch.Generator | None = None,
                 u: torch.Tensor | None = None, axes: torch.Tensor | None = None) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) ~ IGSO3(eps_t) about the identity for
    per-element steps ``t`` (...,); u and the axes are drawn from
    ``generator`` (``igso3_draws``) unless both are given."""
    if u is None or axes is None:
        u, axes = igso3_draws(tuple(t.shape), generator, inv_cdf.device)
    angles = igso3_sample_angle(inv_cdf, t, u)
    axes = axes / torch.clamp(torch.linalg.vector_norm(axes, dim=-1, keepdim=True), min=1e-8)
    return aa_to_rmat(axes, angles)
