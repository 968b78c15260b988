"""Diffusion models."""

from .diffusion_2d import Diffusion2D, Diffusion2DConfig  # noqa: F401
from .diffusion_2d_angle import AngleDiffusion2D, AngleDiffusion2DConfig  # noqa: F401
from .diffusion_2d_discrete import (  # noqa: F401
    DiscreteDiffusion2D,
    DiscreteDiffusion2DConfig,
    DiscreteDiffusion2DRot,
)
from .diffusion_3d import Diffusion3D, Diffusion3DConfig  # noqa: F401
