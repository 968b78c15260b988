"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a missing
card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev
