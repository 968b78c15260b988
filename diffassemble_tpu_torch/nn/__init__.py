"""torch modules: visual and point-cloud encoders, graph-attention backbones,
the 2D and 3D denoisers, the relative-pose head."""

from .denoiser import FusionMLP, GraphDenoiser2D, GraphDenoiser3D  # noqa: F401
from .efficientnet import EfficientNetB0Features, MBConv  # noqa: F401
from .gnn import Exophormer, GraphTransformer, TransformerConvLayer, make_gnn  # noqa: F401
from .layers import BatchNorm2D, init_weights  # noqa: F401
from .pointnet import make_point_encoder  # noqa: F401
from .relpose import RelPoseHead, rel_consensus  # noqa: F401
from .visual import normalize_patches  # noqa: F401
from .vn import VN_DGCNN  # noqa: F401
