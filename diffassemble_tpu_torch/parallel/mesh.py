"""The ('dp', 'tp') mesh — port of the JAX package's ``parallel/mesh.py``.

The JAX package shards the batch over the 'dp' axis of a device mesh and the
denoiser's parameters over 'tp' (``param_sharding_rules``: the Megatron
layout), and lets XLA insert the collectives. Here each of the run's
processes (``torch.distributed``, one card each) is one place on the mesh:
rank r sits at (r // tp, r % tp), as the JAX package lays its devices out, so
the ranks of a tp group are consecutive.

- Data parallelism: each dp place takes its slice of the global batch
  (``shard_batch``) and the model runs under ``DistributedDataParallel`` over
  its dp group (``data_parallel_loss``). What GSPMD makes global over a
  sharded batch is made global here by hand: the loss's random draws are
  drawn for the whole batch and sliced, "batch"-mode BatchNorm and
  OrientationNorm take their statistics over every dp rank's patches, the 3D
  encoders' VNNorm statistics that span the batch axis over every dp rank's
  parts, the 2D loss's masked means divide by the whole batch's valid nodes
  and the 3D relative-pose losses by its contact and pair counts
  (``global_statistics``).
- Tensor parallelism: ``shard_params`` keeps this rank's slices of the
  attention projections and the fusion MLP and switches those modules to
  their tp forward (``nn/gnn.py``, ``nn/denoiser.py``), whose collectives are
  ``parallel/tensor.py``'s; the rest of the model runs replicated on every
  rank of the tp group, on the same dp slice. The model's ``tp_layout``
  (a ``TPLayout``) then gathers whole parameters for the optimizer
  (``train/train_state.py``), checkpoints and evaluation.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from .tensor import TensorParallel, TPLayout, local_slice


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ('dp', 'tp') layout of a run: ``dp`` × ``tp`` processes, this one
    at ``rank``; ``distributed`` when they form a torch.distributed group (the
    train step then runs under DDP, even for one process). ``dp_group`` is
    this rank's dp group (the ranks with its ``tp_rank``; None: the whole run,
    where tp is 1) and ``tp_group`` its tp group (the ranks with its
    ``dp_rank``; None where tp is 1)."""

    dp: int = 1
    tp: int = 1
    rank: int = 0
    distributed: bool = False
    dp_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    tp_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def tensor_parallel(self) -> TensorParallel:
        return TensorParallel(self.tp_group, self.tp, self.tp_rank)


def mesh_groups(dp: int, tp: int) -> tuple[list[list[int]], list[list[int]]]:
    """The ranks of each dp group (one per tp place) and of each tp group (one
    per dp place) of a dp × tp mesh."""
    return ([[d * tp + t for d in range(dp)] for t in range(tp)],
            [[d * tp + t for t in range(tp)] for d in range(dp)])


def make_mesh(n_devices: int | None = None, dp: int | None = None, tp: int = 1) -> Mesh:
    """A ('dp', 'tp') mesh over ``n_devices`` processes (default: all of the
    run's). Every process of the run must have a place on it. With tp > 1
    every process makes every group, in the same order (``dist.new_group``)."""
    distributed = dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if distributed else (1, 0)
    n = n_devices or world
    dp = n // tp if dp is None else dp
    if dp * tp != n:
        raise ValueError(f"dp({dp})*tp({tp}) != devices({n})")
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a run of {world} processes: "
                         f"launch one process per device of the mesh")
    if tp == 1:
        return Mesh(dp=dp, tp=tp, rank=rank, distributed=distributed)
    dp_ranks, tp_ranks = mesh_groups(dp, tp)
    dp_groups = [dist.new_group(r) for r in dp_ranks]
    tp_groups = [dist.new_group(r) for r in tp_ranks]
    return Mesh(dp=dp, tp=tp, rank=rank, distributed=True, dp_group=dp_groups[rank % tp],
                tp_group=tp_groups[rank // tp])


def auto_mesh(batch_size: int, tp: int = 1) -> Mesh:
    """A mesh whose dp is the largest divisor of ``batch_size`` that fits the
    run's processes."""
    n = max((dist.get_world_size() if dist.is_initialized() else 1) // tp, 1)
    dp = next(d for d in range(min(batch_size, n), 0, -1) if batch_size % d == 0)
    return make_mesh(dp * tp, dp=dp, tp=tp)


def shard_batch(mesh: Mesh, batch):
    """This rank's dp slice of every field's leading (batch) axis."""
    b = batch[0].shape[0]
    if b % mesh.dp:
        raise ValueError(f"a batch of {b} does not split over dp={mesh.dp}")
    k = b // mesh.dp
    return type(batch)(*[f[mesh.dp_rank * k:(mesh.dp_rank + 1) * k] for f in batch])


def param_sharding_rules(mesh: Mesh, model: torch.nn.Module) -> dict[str, int | None]:
    """The tensor-parallel layout of ``model``'s parameters over 'tp': for each
    parameter's name, the dimension split over the tp group, or None where it
    is replicated (every parameter where tp is 1). The JAX package's rules,
    rule for rule, in the port's (out, in) Linear layout:

    - every ``TransformerConvLayer``'s ``query``, ``key``, ``value`` and
      ``skip`` projections are column-parallel over the heads: the weight on
      dim 0 (the JAX kernel's ``P(None, 'tp')``) and the bias on dim 0;
    - the fusion MLP is Megatron's pair where its hidden width divides by
      tp: ``fc1`` column-parallel (weight and bias on dim 0), ``fc2``
      row-parallel (weight on dim 1, the JAX kernel's ``P('tp', None)``; its
      bias replicated);
    - everything else is replicated.

    Raises where a layer's heads do not split over tp."""
    from ..nn.denoiser import FusionMLP
    from ..nn.gnn import TransformerConvLayer

    rules: dict[str, int | None] = {name: None for name, _ in model.named_parameters()}
    if mesh.tp == 1:
        return rules
    for prefix, m in model.named_modules():
        at = f"{prefix}." if prefix else ""
        if isinstance(m, TransformerConvLayer):
            if m.heads % mesh.tp:
                raise ValueError(f"{prefix}: {m.heads} heads do not split over tp={mesh.tp}")
            for proj in ("skip", "query", "key", "value"):
                rules[f"{at}{proj}.weight"] = rules[f"{at}{proj}.bias"] = 0
        elif isinstance(m, FusionMLP) and m.fc1.out_features % mesh.tp == 0:
            rules[f"{at}fc1.weight"] = rules[f"{at}fc1.bias"] = 0
            rules[f"{at}fc2.weight"] = 1
    return rules


def shard_params(mesh: Mesh, model: torch.nn.Module) -> TPLayout | None:
    """Keep this rank's slices of ``model``'s sharded parameters in place
    (``param_sharding_rules``), switch the modules that hold them to their tp
    forward and set ``model.tp_layout``; returns it (None where tp is 1).
    The Parameter objects stay the same, so call it before an optimizer or
    DDP takes their shapes. Every rank of the tp group must hold the same
    whole parameters (the same seed, or the same checkpoint)."""
    from ..nn.denoiser import FusionMLP
    from ..nn.gnn import TransformerConvLayer

    if getattr(model, "tp_layout", None) is not None:
        raise ValueError("the model is sharded already")
    if mesh.tp == 1:
        return None
    tp = mesh.tensor_parallel
    dims = param_sharding_rules(mesh, model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if dims[name] is not None:
                p.data = local_slice(p.data, dims[name], tp)
    for prefix, m in model.named_modules():
        at = f"{prefix}." if prefix else ""
        if isinstance(m, TransformerConvLayer) or (isinstance(m, FusionMLP) and dims[f"{at}fc1.weight"] is not None):
            m.tp = tp
    model.tp_layout = TPLayout(tp, dims)
    return model.tp_layout


def gather_params(model: torch.nn.Module, params: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
    """The whole parameters of a sharded ``model`` (or of ``params``, tensors
    by the model's parameter names, e.g. the EMA) by name; every rank of the
    tp group calls it alike. A model that is not sharded gives its own."""
    params = dict(model.named_parameters()) if params is None else params
    layout = getattr(model, "tp_layout", None)
    return {k: v.detach() for k, v in (params if layout is None else layout.gather_all(params)).items()}


def unshard_params(model: torch.nn.Module) -> None:
    """Make a sharded ``model`` whole again in place (the inverse of
    ``shard_params``); a model that is not sharded is left as it is."""
    from ..nn.denoiser import FusionMLP
    from ..nn.gnn import TransformerConvLayer

    layout = getattr(model, "tp_layout", None)
    if layout is None:
        return
    whole = layout.gather_all(dict(model.named_parameters()))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = whole[name]
    for m in model.modules():
        if isinstance(m, (TransformerConvLayer, FusionMLP)):
            m.tp = None
    model.tp_layout = None


@contextlib.contextmanager
def global_statistics(model: torch.nn.Module, group):
    """Within, the model's batch statistics (BatchNorm, OrientationNorm,
    VNNorm) and its loss's batch-wide counts span ``group``'s ranks (every
    module with a ``stats_group`` attribute)."""
    holders = [m for m in model.modules() if hasattr(m, "stats_group")]
    for m in holders:
        m.stats_group = group
    try:
        yield
    finally:
        for m in holders:
            m.stats_group = None


class _Loss(torch.nn.Module):
    """``model.loss`` as a forward, which DDP wraps."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch, **draws):
        return self.model.loss(batch, **draws)


def data_parallel_loss(model, mesh: Mesh):
    """``loss_fn(batch, generator)`` of ``model.loss`` for
    ``train_state.make_train_step`` on ``mesh``; ``batch`` is this rank's dp
    slice. Without a process group it is ``model.loss`` itself. With one, the
    loss runs under DDP over the dp group (the gradients are the group's
    mean), every rank draws the loss's draws for the whole batch from the
    same generator and keeps its dp slice, and with dp > 1 the statistics are
    global over the dp group (``global_statistics``), so that the step is the
    single-process step on the whole batch; the returned aux is the dp
    group's mean. The ranks of a tp group run the same slice (a sharded
    model's collectives are its own)."""
    if not mesh.distributed:
        return model.loss
    ddp = torch.nn.parallel.DistributedDataParallel(
        _Loss(model), device_ids=[model.device.index] if model.device.type == "cuda" else None,
        process_group=mesh.dp_group, find_unused_parameters=bool(model.cfg.freeze_backbone))
    group = dist.group.WORLD if mesh.dp_group is None else mesh.dp_group

    def loss_fn(batch, generator):
        b = batch.x0.shape[0]
        draws = model.loss_draws(b * mesh.dp, (b * mesh.dp, *batch.x0.shape[1:]), generator, batch.x0.device)
        draws = {k: v[mesh.dp_rank * b:(mesh.dp_rank + 1) * b] for k, v in draws.items()}
        with global_statistics(model, group) if mesh.dp > 1 else contextlib.nullcontext():
            loss, aux = ddp(batch, **draws)
        if mesh.dp > 1:
            keys = sorted(aux)
            with torch.no_grad():
                values = torch.stack([torch.as_tensor(aux[k], device=loss.device).float() for k in keys])
                dist.all_reduce(values, group=group)
            aux = dict(zip(keys, values / mesh.dp))
        return loss, aux

    return loss_fn
