"""Train state and train-step factory — port of the JAX package's ``train/train_state.py``.

The JAX package jits one donated step over a (params, opt_state, step, rng)
pytree. Here the params are the model's own parameters, updated in place
under ``no_grad`` (the port's counterpart of donation); the rng is a
``torch.Generator`` that the loss draws from; gradient accumulation is a loop
over microbatches.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import nn


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]  # the model's parameters by name (updated in place)
    opt_state: dict
    step: int
    generator: torch.Generator
    # exponential moving average of params for evaluation (None = EMA off)
    ema_params: dict[str, torch.Tensor] | None = None


def create_train_state(model: nn.Module, optimizer, generator: torch.Generator,
                       ema: bool = False) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=0,
        generator=generator,
        ema_params={k: p.detach().clone() for k, p in params.items()} if ema else None,
    )


def eval_params(state: TrainState) -> dict[str, torch.Tensor]:
    """Params to evaluate/serve with: the EMA average when the state carries
    one, else the live params."""
    return state.ema_params if state.ema_params is not None else state.params


def global_norm(tensors) -> torch.Tensor:
    """√(Σ x²) over all tensors, in f32 (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def _split(batch, accumulate: int, i: int):
    """Microbatch ``i`` of ``accumulate`` along the leading axis of every field."""
    return type(batch)(*[f.reshape(accumulate, f.shape[0] // accumulate, *f.shape[1:])[i] for f in batch])


def make_train_step(
    loss_fn: Callable[[Any, torch.Generator], tuple[torch.Tensor, dict]],
    optimizer,
    accumulate: int = 1,
    max_grad_norm: float | None = 10.0,
    ema_decay: float | None = None,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Build the train step: ``step(state, batch) → (state, aux)``.

    ``loss_fn(batch, generator) → (loss, aux)`` reads the parameters that
    ``state.params`` holds (e.g. a model's bound ``loss``). With
    accumulate > 1 the batch's leading axis is split into ``accumulate``
    microbatches and their gradients are averaged.

    Non-finite gradient entries are zeroed (``grad_nonfinite`` says so), then
    the global gradient norm is clipped to ``max_grad_norm`` with an
    overflow-safe norm, then the optimizer updates the parameters in place
    and the warmup-debiased EMA follows. The clipped gradients stay in each
    parameter's ``.grad`` until the next step.
    """

    def clip(grads: list[torch.Tensor]) -> None:
        if max_grad_norm is None:
            return
        # ||g|| = m·||g/m|| with m = max|entry|: a direct sum of squares
        # overflows f32 once an entry exceeds ~2e19, which would make the
        # scale exactly 0 and silently freeze training
        absmax = torch.stack([g.abs().amax() for g in grads]).amax()
        m = torch.clamp(absmax, min=1.0)
        gnorm = m * global_norm(g / m for g in grads)
        scale = torch.clamp(max_grad_norm / (gnorm + 1e-9), max=1.0)
        for g in grads:
            g.mul_(scale)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state.params
        for p in params.values():
            p.grad = None
        if accumulate == 1:
            loss, aux = loss_fn(batch, state.generator)
            loss.backward()
            aux = {k: torch.as_tensor(v).detach() for k, v in aux.items()}
        else:
            total = 0.0
            for i in range(accumulate):
                loss, _ = loss_fn(_split(batch, accumulate, i), state.generator)
                loss.backward()
                total = total + loss.detach()
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(accumulate)
            aux = {"loss": total / accumulate}
        for p in params.values():
            if p.grad is None:  # a parameter the loss does not reach
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params.values()]

        # non-finite guard BEFORE the clip: one Inf would drive the global
        # norm to inf and the clip scale to 0, zeroing every gradient; zero
        # only the offending entries and report the event
        with torch.no_grad():
            all_finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            for g in grads:
                g.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
            clip(grads)
            updates, opt_state = optimizer.update(
                {k: p.grad for k, p in params.items()}, state.opt_state, params)
            for k, p in params.items():
                p.add_(updates[k])
            ema = state.ema_params
            if ema_decay is not None and ema is not None:
                # warmup-debiased decay: early steps track params closely
                t = np.float32(state.step + 1)
                d = min(np.float32(ema_decay), (np.float32(1.0) + t) / (np.float32(10.0) + t))
                d, keep = float(d), float(np.float32(1.0) - d)
                for k, e in ema.items():
                    e.copy_(d * e + keep * params[k])
            aux["grad_norm"] = global_norm(grads)
            aux["grad_nonfinite"] = 1.0 - all_finite.float()
            # per-subtree norms (encoder vs denoiser)
            groups: dict[str, list[torch.Tensor]] = {}
            for k, p in params.items():
                groups.setdefault(k.split(".", 1)[0], []).append(p.grad)
            for k, gs in groups.items():
                aux[f"grad_norm/{k}"] = global_norm(gs)
        return TrainState(params, opt_state, state.step + 1, state.generator, ema), aux

    return step

