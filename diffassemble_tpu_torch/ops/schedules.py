"""Diffusion noise schedules — port of the JAX package's ``ops/schedules.py:62-118``.

The tables are computed in float64 numpy and stored as float32 tensors on the
requested device, as the JAX package stores them as float32 arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def linear_betas(steps: int) -> np.ndarray:
    return np.linspace(1e-4, 0.02, steps, dtype=np.float64)


def quadratic_betas(steps: int) -> np.ndarray:
    return np.linspace(1e-4**0.5, 0.02**0.5, steps, dtype=np.float64) ** 2


def sigmoid_betas(steps: int) -> np.ndarray:
    x = np.linspace(-6, 6, steps, dtype=np.float64)
    return 1.0 / (1.0 + np.exp(-x)) * (0.02 - 1e-4) + 1e-4


def cosine_betas(steps: int, s: float = 0.08) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule (arXiv:2102.09672)."""
    x = np.linspace(0, steps, steps + 1, dtype=np.float64)
    ac = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = 1 - (ac[1:] / ac[:-1])
    return np.clip(betas, 1e-4, 0.9999)


def cosine_discrete_betas(steps: int, s: float = 0.08) -> np.ndarray:
    """Betas from the ratio of a non-squared, phase-shifted cosine."""
    t = np.linspace(0, steps, steps + 1, dtype=np.float64)
    f = lambda u: np.cos(((u / steps) + s) / (1 + s) + np.pi / 2)  # noqa: E731
    betas = 1 - f(t[:-1] + 1) / f(t[:-1])
    return np.clip(betas, 1e-4, 0.9999)


_BETA_FNS = {
    "linear": linear_betas,
    "cosine": cosine_betas,
    "cosine_discrete": cosine_discrete_betas,
    "quadratic": quadratic_betas,
    "sigmoid": sigmoid_betas,
}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep quantities needed by q_sample / DDPM / DDIM, shape (T,)."""

    steps: int
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor

    @staticmethod
    def create(
        steps: int, scheduler: str = "linear", device: torch.device | str = "cpu"
    ) -> "DiffusionSchedule":
        betas = _BETA_FNS[scheduler](steps)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.concatenate([[1.0], ac[:-1]])

        def f32(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

        return DiffusionSchedule(
            steps=steps,
            betas=f32(betas),
            alphas=f32(alphas),
            alphas_cumprod=f32(ac),
            alphas_cumprod_prev=f32(ac_prev),
            sqrt_recip_alphas=f32(np.sqrt(1.0 / alphas)),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1.0)),
            posterior_variance=f32(betas * (1.0 - ac_prev) / (1.0 - ac)),
        )

    def timesteps(self, inference_ratio: int = 1) -> np.ndarray:
        """The reverse-process visit order: reversed(range(0, T, ratio))."""
        return np.asarray(list(reversed(range(0, self.steps, inference_ratio))), dtype=np.int32)


def extract(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Gather per-timestep coefficients: ``a`` (T,), integer ``t`` (...,) → (..., 1)."""
    return a[t.long()][..., None]
