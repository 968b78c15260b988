"""Core ops: schedules, Gaussian diffusion, masked attention (+ CUDA kernel), assignment,
the Rotation3D container, distributions on SE(3)/SO(3) and MMD tests."""

from .assignment import greedy_assignment, greedy_assignment_batch  # noqa: F401
from .attention import (  # noqa: F401
    build_adjacency_mask,
    extend_mask_with_virtual_nodes,
    fully_connected_mask,
    masked_attention,
)
from .cuda_attention import masked_attention_fwd, masked_attention_fwd_plain  # noqa: F401
from .gaussian import (  # noqa: F401
    ddim_step,
    ddpm_step,
    predict_eps_from_xstart,
    predict_xstart_from_eps,
    q_sample,
    sample_loop,
)
from .schedules import DiffusionSchedule, extract  # noqa: F401
from .rotation3d import Rotation3D  # noqa: F401
from .distributions import AffineT, bingham_sample, igso3xr3_sample, mmd_rbf, mmd_rotation  # noqa: F401
