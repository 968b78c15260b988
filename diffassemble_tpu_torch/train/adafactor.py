"""Adafactor as the JAX package's ``make_optimizer`` builds it, written out.

The counterpart of ``optax.adafactor(learning_rate=schedule,
multiply_by_parameter_scale=True)`` with optax's defaults (optax 0.2.6):
factored second moments for parameters whose two largest dimensions are both
≥ 128 (``min_dim_size_to_factor``), decay 1 − (t + 1)^−0.8, ε = 1e-30, the
update clipped to RMS 1, scaled by the learning rate, then by the parameter's
RMS floored at 1e-3, no momentum, and applied with a minus sign. The HF
relative schedule min(1e-2, 1/√max(t, 1)) × min(1, t/warmup) is read at the
count of earlier updates, so with warmup the first update is exactly 0.

optax factors over the two largest dimensions of the JAX package's layout of
each parameter (argsort order breaks ties): a Dense kernel (in, out), a conv
kernel HWIO. The port's Linear weights are (out, in) and its conv weights
OIHW, so each parameter is viewed in the JAX layout (``layouts``: a
permutation per parameter name, from ``reference_layouts``) while its update
is computed. torch's own ``Adafactor`` is a different rule and is not used.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

_F32 = np.float32
# optax.adafactor's defaults, the only values the JAX package uses
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPS = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_PARAM_SCALE = 1e-3


def hf_relative_schedule(warmup_steps: int = 0) -> Callable[[int], float]:
    """Step size at update count ``step``, computed in float32 as the JAX schedule is."""

    def schedule(step: int) -> float:
        s = _F32(step)
        lr = np.minimum(_F32(1e-2), _F32(1.0) / np.sqrt(np.maximum(s, _F32(1.0))))
        if warmup_steps > 0:
            lr = lr * np.minimum(_F32(1.0), s / _F32(warmup_steps))
        return float(_F32(lr))

    return schedule


def reference_layouts(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """Permutation of each Linear and conv weight into the JAX package's
    layout: Linear (out, in) → (in, out), conv OIHW → HWIO. Other parameters
    have the same layout in both packages and are left out."""
    out = {}
    for prefix, module in model.named_modules():
        name = f"{prefix}.weight" if prefix else "weight"
        if isinstance(module, nn.Linear):
            out[name] = (1, 0)
        elif isinstance(module, nn.Conv2d):
            out[name] = (2, 3, 1, 0)
    return out


def _factored_dims(shape: tuple[int, ...]) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: the second-largest and largest axes, or None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor:
    """Functional like optax: ``init(params) → state``,
    ``update(grads, state, params) → (updates, state)``; params, grads and
    updates are dicts of tensors by parameter name in the port's layout, the
    state's moments are in the JAX layout. ``learning_rate`` maps the count
    of earlier updates to the step size; ``layouts`` is ``reference_layouts``
    of the model the parameters belong to."""

    def __init__(self, learning_rate: Callable[[int], float], layouts: dict[str, tuple[int, ...]]):
        self.learning_rate = learning_rate
        self.layouts = layouts

    def _ref(self, name: str, x: torch.Tensor) -> torch.Tensor:
        perm = self.layouts.get(name)
        return x.permute(perm) if perm else x

    def _from_ref(self, name: str, x: torch.Tensor) -> torch.Tensor:
        perm = self.layouts.get(name)
        return x.permute(tuple(np.argsort(perm))) if perm else x

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        v_row, v_col, v = {}, {}, {}
        for name, p in params.items():
            shape = tuple(self._ref(name, p).shape)
            dims = _factored_dims(shape)
            if dims is not None:
                d1, d0 = dims
                v_row[name] = p.new_zeros(tuple(np.delete(shape, d0)))
                v_col[name] = p.new_zeros(tuple(np.delete(shape, d1)))
            else:
                v[name] = p.new_zeros(shape)
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict, params: dict[str, torch.Tensor]):
        count = state["count"]
        decay = _F32(1.0) - _F32(count + 1) ** _F32(-DECAY_RATE)
        keep = float(_F32(1.0) - decay)
        decay = float(decay)
        lr = self.learning_rate(count)
        new = {"count": count + 1, "v_row": {}, "v_col": {}, "v": {}}
        updates = {}
        for name, g_port in grads.items():
            g = self._ref(name, g_port)
            grad_sqr = g * g + EPS
            dims = _factored_dims(tuple(g.shape))
            if dims is not None:
                d1, d0 = dims
                v_row = decay * state["v_row"][name] + keep * grad_sqr.mean(dim=d0)
                v_col = decay * state["v_col"][name] + keep * grad_sqr.mean(dim=d1)
                new["v_row"][name], new["v_col"][name] = v_row, v_col
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                col_factor = v_col**-0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            else:
                v = decay * state["v"][name] + keep * grad_sqr
                new["v"][name] = v
                u = g * v**-0.5
            rms = u.square().mean().sqrt()
            u = u / torch.clamp(rms / CLIPPING_THRESHOLD, min=1.0) * lr
            p_rms = params[name].square().mean().sqrt()
            u = u * torch.where(p_rms <= MIN_PARAM_SCALE, MIN_PARAM_SCALE, p_rms)
            updates[name] = self._from_ref(name, -u)
        return updates, new
