"""The data-parallel mesh — port of the data-parallel half of the JAX
package's ``parallel/mesh.py``.

The JAX package shards the batch over the 'dp' axis of a device mesh and lets
XLA insert the gradient all-reduce. Here each of the run's processes
(``torch.distributed``, one card each) is one place on 'dp': it takes its
slice of the global batch (``shard_batch``) and the model runs under
``DistributedDataParallel`` (``data_parallel_loss``). What GSPMD makes global
over a sharded batch is made global here by hand: the loss's random draws are
drawn for the whole batch and sliced, "batch"-mode BatchNorm and
OrientationNorm take their statistics over every rank's patches, the 3D
encoders' VNNorm statistics that span the batch axis over every rank's
parts, the 2D loss's masked means divide by the whole batch's valid nodes
and the 3D relative-pose losses by its contact and pair counts
(``global_statistics``). The tensor-parallel
'tp' axis is not ported (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

TP_ITEM = "tensor parallelism (tp > 1, param_sharding_rules) is not ported yet: ROADMAP Queue 1 item 16"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ('dp', 'tp') layout of a run: ``dp`` processes, this one at
    ``rank``; ``distributed`` when they form a torch.distributed group (the
    train step then runs under DDP, even for one process)."""

    dp: int = 1
    tp: int = 1
    rank: int = 0
    distributed: bool = False

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}


def make_mesh(n_devices: int | None = None, dp: int | None = None, tp: int = 1) -> Mesh:
    """A ('dp', 'tp') mesh over ``n_devices`` processes (default: all of the
    run's). Every process of the run must have a place on it."""
    if tp != 1:
        raise NotImplementedError(TP_ITEM)
    distributed = dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if distributed else (1, 0)
    n = n_devices or world
    dp = n // tp if dp is None else dp
    if dp * tp != n:
        raise ValueError(f"dp({dp})*tp({tp}) != devices({n})")
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a run of {world} processes: "
                         f"launch one process per device of the mesh")
    return Mesh(dp=dp, tp=tp, rank=rank, distributed=distributed)


def auto_mesh(batch_size: int, tp: int = 1) -> Mesh:
    """A mesh whose dp is the largest divisor of ``batch_size`` that fits the
    run's processes."""
    n = max((dist.get_world_size() if dist.is_initialized() else 1) // tp, 1)
    dp = next(d for d in range(min(batch_size, n), 0, -1) if batch_size % d == 0)
    return make_mesh(dp * tp, dp=dp, tp=tp)


def shard_batch(mesh: Mesh, batch):
    """This rank's slice of every field's leading (batch) axis."""
    b = batch[0].shape[0]
    if b % mesh.dp:
        raise ValueError(f"a batch of {b} does not split over dp={mesh.dp}")
    k = b // mesh.dp
    return type(batch)(*[f[mesh.rank * k:(mesh.rank + 1) * k] for f in batch])


def param_sharding_rules(mesh: Mesh, params):
    raise NotImplementedError(TP_ITEM)


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
    ``train_state.make_train_step`` on ``mesh``; ``batch`` is this rank's
    slice. Without a process group it is ``model.loss`` itself. With one, the
    loss runs under DDP (the gradients are the group's mean), every rank
    draws the loss's draws for the whole batch from the same generator and
    keeps its slice, and with dp > 1 the statistics are global
    (``global_statistics``), so that the step is the single-process step on
    the whole batch; the returned aux is the group's mean."""
    if not mesh.distributed:
        return model.loss
    ddp = torch.nn.parallel.DistributedDataParallel(
        _Loss(model), device_ids=[model.device.index] if model.device.type == "cuda" else None,
        find_unused_parameters=bool(model.cfg.freeze_backbone))

    def loss_fn(batch, generator):
        b = batch.x0.shape[0]
        draws = model.loss_draws(b * mesh.dp, (b * mesh.dp, *batch.x0.shape[1:]), generator, batch.x0.device)
        draws = {k: v[mesh.rank * b:(mesh.rank + 1) * b] for k, v in draws.items()}
        with global_statistics(model, dist.group.WORLD) if mesh.dp > 1 else contextlib.nullcontext():
            loss, aux = ddp(batch, **draws)
        if mesh.dp > 1:
            keys = sorted(aux)
            with torch.no_grad():
                values = torch.stack([torch.as_tensor(aux[k], device=loss.device).float() for k in keys])
                dist.all_reduce(values)
            aux = dict(zip(keys, values / mesh.dp))
        return loss, aux

    return loss_fn
