"""Diffusion models."""

from .diffusion_2d import Diffusion2D, Diffusion2DConfig  # noqa: F401
