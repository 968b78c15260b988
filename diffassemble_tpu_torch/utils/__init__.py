"""Utilities: device resolution and visualisation."""

from .device import resolve_device  # noqa: F401
from .viz import compose_from_positions  # noqa: F401
