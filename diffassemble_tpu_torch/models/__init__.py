"""Diffusion models."""

from .diffusion_2d import Diffusion2D, Diffusion2DConfig  # noqa: F401
from .diffusion_3d import Diffusion3D, Diffusion3DConfig  # noqa: F401
