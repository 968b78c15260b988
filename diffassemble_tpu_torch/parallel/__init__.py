"""Data- and tensor-parallel training over torch.distributed — port of the
JAX package's ``parallel/`` (its ('dp', 'tp') mesh and Megatron layout)."""

from .distributed import PreemptionGuard, initialize, is_main_process  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    auto_mesh,
    data_parallel_loss,
    gather_params,
    make_mesh,
    param_sharding_rules,
    shard_batch,
    shard_params,
    unshard_params,
)
from .tensor import TensorParallel, TPLayout, copy_to_tp, gather_from_tp, reduce_from_tp  # noqa: F401
