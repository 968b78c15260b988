"""Tensor parallelism over the 'tp' axis: its collectives and the layout of a
sharded model.

The JAX package shards the Megatron layout of ``parallel/mesh.py``'s
``param_sharding_rules`` and GSPMD inserts the collectives. Here they are
explicit, as ``torch.autograd.Function``s over a tp group
(``TensorParallel``):

- ``copy_to_tp``: the identity forward, an all-reduce of the gradient
  backward; in front of a column-parallel layer, whose input every rank holds
  whole;
- ``reduce_from_tp``: an all-reduce forward, the identity backward; after a
  row-parallel product, whose partial sums the ranks add;
- ``gather_from_tp``: an all-gather along one axis forward, the rank's own
  slice of the gradient backward; after a column-parallel layer, whose output
  the rest of the model needs whole (the rest runs replicated, so every rank
  holds the same whole gradient and the slice is all a rank's part needs).

A tp group of one makes each the identity. Every collective is an
``all_reduce`` in f32, which every ``torch.distributed`` backend takes for CUDA
tensors (gloo too, which the one-card rehearsal runs: NCCL refuses two ranks
on one device): a bf16 input is widened exactly, summed in f32 and rounded
once, and an all-gather is the all-reduce of a zero-filled buffer into which
each rank writes its slice, exact in value.

``TPLayout`` is a model's sharded layout: which dimension of each parameter
is split over the group (``parallel/mesh.py:shard_params`` makes it), with
``gather`` and ``local`` to go between this rank's slice and the whole
tensor, and ``sync_replicated`` to keep the replicated parameters equal on
every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One tp group: its process group, its size and this rank's place in it."""

    group: Any
    size: int
    rank: int


def _all_reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The group's sum of ``x``, computed in f32, in ``x``'s type."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=tp.group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    """The ranks' slices of a tensor split evenly along ``dim``, joined in rank
    order (no gradient)."""
    if tp.size == 1:
        return x
    dim = dim % x.dim()
    c = x.shape[dim]
    shape = (*x.shape[:dim], c * tp.size, *x.shape[dim + 1:])
    buf = torch.zeros(shape, dtype=torch.float32, device=x.device)
    buf.narrow(dim, tp.rank * c, c).copy_(x)
    dist.all_reduce(buf, group=tp.group)
    return buf.to(x.dtype)


def local_slice(x: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (a contiguous copy)."""
    if x.shape[dim] % tp.size:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over tp={tp.size}")
    return x.chunk(tp.size, dim)[tp.rank].contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return all_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, grad):
        return local_slice(grad, ctx.dim, ctx.tp), None, None


def copy_to_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return x if tp.size == 1 else _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return x if tp.size == 1 else _ReduceFromTP.apply(x, tp)


def gather_from_tp(x: torch.Tensor, tp: TensorParallel, dim: int = -1) -> torch.Tensor:
    return x if tp.size == 1 else _GatherFromTP.apply(x, tp, dim)


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """A sharded model's layout: ``dims`` maps each parameter's name to the
    dimension split over ``tp``, or None where it is replicated."""

    tp: TensorParallel
    dims: dict[str, int | None]

    def gather(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` from this rank's slice ``x``."""
        d = self.dims.get(name)
        return x if d is None else all_gather(x.detach(), d, self.tp)

    def local(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``x`` of parameter ``name``."""
        d = self.dims.get(name)
        return x if d is None else local_slice(x, d, self.tp)

    def gather_all(self, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """``gather`` of every entry: the whole tensors, by name (every rank of
        the group calls it alike)."""
        return {k: self.gather(k, v) for k, v in tensors.items()}

    def sync_replicated(self, grads: dict[str, torch.Tensor]) -> None:
        """Replace every replicated parameter's gradient by its mean over the
        group, in place (one all-reduce). The ranks run the replicated part
        alike, but on the card a backward's atomic sums (scatters, gathers)
        round in any order: without this their replicated weights would
        drift apart. Where the ranks' gradients agree it changes nothing at
        tp = 2 (a + a and its half are exact)."""
        reps = [g for k, g in grads.items() if self.dims.get(k) is None]
        if self.tp.size == 1 or not reps:
            return
        flat = torch.cat([g.reshape(-1).float() for g in reps])
        dist.all_reduce(flat, group=self.tp.group)
        flat /= self.tp.size
        for g, part in zip(reps, flat.split([g.numel() for g in reps])):
            g.copy_(part.view_as(g))

    def full_shape(self, name: str, x: torch.Tensor) -> tuple[int, ...]:
        d = self.dims.get(name)
        shape = list(x.shape)
        if d is not None:
            shape[d] *= self.tp.size
        return tuple(shape)
