"""Data-parallel training over torch.distributed — port of the JAX package's
``parallel/`` (its ('dp', 'tp') mesh; the tensor-parallel half is not ported)."""

from .distributed import PreemptionGuard, initialize, is_main_process  # noqa: F401
from .mesh import Mesh, auto_mesh, data_parallel_loss, make_mesh, shard_batch  # noqa: F401
