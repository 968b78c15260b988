"""Euclidean Gaussian diffusion: forward noising and DDPM/DDIM reverse updates.

Port of the JAX package's ``ops/gaussian.py``. Every function broadcasts over
arbitrary leading shape: state is (..., C) and ``t`` is integer (...,). The JAX
package runs the reverse process as one ``lax.scan``; here ``sample_loop`` is a
Python loop over the static timesteps, with noise drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .schedules import DiffusionSchedule, extract


def q_sample(
    sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Forward noising q(x_t | x_0) = sqrt(ᾱ_t) x_0 + sqrt(1-ᾱ_t) ε."""
    return (
        extract(sched.sqrt_alphas_cumprod, t) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t) * noise
    )


def predict_xstart_from_eps(
    sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor, eps: torch.Tensor
) -> torch.Tensor:
    """x̂₀ = (x_t − √(1−ᾱ_t)·ε) / √ᾱ_t."""
    ac = extract(sched.alphas_cumprod, t)
    return (x_t - torch.sqrt(1.0 - ac) * eps) / torch.sqrt(ac)


def predict_eps_from_xstart(
    sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor, x0: torch.Tensor
) -> torch.Tensor:
    """ε̂ = (x_t/√ᾱ_t − x̂₀) / √(1/ᾱ_t − 1)."""
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t) * x_t - x0
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t)


def _alpha_prod_prev(sched: DiffusionSchedule, t_prev: torch.Tensor) -> torch.Tensor:
    """ᾱ at t_prev, with ᾱ = 1 where t_prev < 0."""
    ac = extract(sched.alphas_cumprod, torch.clamp(t_prev, min=0))
    return torch.where(t_prev[..., None] >= 0, ac, torch.ones_like(ac))


def ddim_variance(
    sched: DiffusionSchedule, t: torch.Tensor, t_prev: torch.Tensor
) -> torch.Tensor:
    """σ²_t for DDIM; t_prev<0 ⇒ ᾱ_prev=1."""
    alpha_prod = extract(sched.alphas_cumprod, t)
    alpha_prod_prev = _alpha_prod_prev(sched, t_prev)
    beta = 1 - alpha_prod
    beta_prev = 1 - alpha_prod_prev
    return (beta_prev / beta) * (1 - alpha_prod / alpha_prod_prev)


def ddim_step(
    sched: DiffusionSchedule,
    x: torch.Tensor,
    t: torch.Tensor,
    model_output: torch.Tensor,
    inference_ratio: int,
    mean_type: str = "epsilon",
    eta: float = 0.0,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One DDIM reverse update x_t → x_{t-ratio}.

    With eta=0 the update is deterministic; eta=1 recovers DDPM-like variance.
    """
    t_prev = t - inference_ratio
    alpha_prod = extract(sched.alphas_cumprod, t)
    alpha_prod_prev = _alpha_prod_prev(sched, t_prev)
    beta = 1 - alpha_prod

    if mean_type == "epsilon":
        x0 = (x - torch.sqrt(beta) * model_output) / torch.sqrt(alpha_prod)
    else:
        x0 = model_output
    eps = predict_eps_from_xstart(sched, x, t, x0)

    variance = ddim_variance(sched, t, t_prev)
    std_eta = eta * torch.sqrt(variance)

    direction = torch.sqrt(1 - alpha_prod_prev - std_eta**2) * eps
    prev = torch.sqrt(alpha_prod_prev) * x0 + direction
    if eta > 0:
        if noise is None:
            raise ValueError("eta > 0 requires explicit noise")
        prev = prev + std_eta * noise
    return prev


def ddpm_step(
    sched: DiffusionSchedule,
    x: torch.Tensor,
    t: torch.Tensor,
    model_output_eps: torch.Tensor,
    noise: torch.Tensor,
    t_is_zero: bool,
) -> torch.Tensor:
    """One ancestral DDPM update from an ε-prediction; no noise when ``t_is_zero``."""
    betas_t = extract(sched.betas, t)
    sqrt_one_minus_ac = extract(sched.sqrt_one_minus_alphas_cumprod, t)
    sqrt_recip_alphas = extract(sched.sqrt_recip_alphas, t)
    model_mean = sqrt_recip_alphas * (x - betas_t * model_output_eps / sqrt_one_minus_ac)
    if t_is_zero:
        return model_mean
    return model_mean + torch.sqrt(extract(sched.posterior_variance, t)) * noise


class SampleLoopResult(NamedTuple):
    final: torch.Tensor  # (..., C) final denoised state
    trajectory: torch.Tensor | None  # (S, ..., C) all intermediate states, or None


def sample_loop(
    sched: DiffusionSchedule,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    init: torch.Tensor,
    generator: torch.Generator | None = None,
    inference_ratio: int = 1,
    sampling: str = "ddim",
    mean_type: str = "epsilon",
    eta: float | None = None,
    keep_trajectory: bool = False,
    noise: torch.Tensor | None = None,
) -> SampleLoopResult:
    """Run the full reverse process over the static timesteps.

    ``denoise_fn(x, t)`` is the model: x is (..., C), t is int (...,) per
    element. Stochastic steps draw noise from ``generator`` (on ``init``'s
    device), unless ``noise`` (S, *init.shape) supplies the draws, as the tests
    do to feed the JAX package and this one the same numbers.
    """
    if eta is None:
        eta = 1.0 if sampling == "ddpm" else 0.0
    x = init
    traj = []
    for i, t_scalar in enumerate(sched.timesteps(inference_ratio).tolist()):
        t = torch.full(init.shape[:-1], t_scalar, dtype=torch.int32, device=init.device)
        out = denoise_fn(x, t)
        stochastic = sampling == "ddpm" or eta > 0
        step_noise = None
        if stochastic:
            step_noise = noise[i] if noise is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=x.dtype
            )
        if sampling == "ddpm":
            # the ancestral update is parameterized in ε; convert x₀ predictions
            eps = out if mean_type == "epsilon" else predict_eps_from_xstart(sched, x, t, out)
            x = ddpm_step(sched, x, t, eps, step_noise, t_is_zero=t_scalar == 0)
        else:
            x = ddim_step(
                sched, x, t, out, inference_ratio, mean_type=mean_type, eta=eta, noise=step_noise
            )
        if keep_trajectory:
            traj.append(x)
    return SampleLoopResult(final=x, trajectory=torch.stack(traj) if keep_trajectory else None)
