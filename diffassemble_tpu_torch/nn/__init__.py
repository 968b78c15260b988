"""torch modules: visual encoder, graph-attention backbones, the 2D denoiser."""

from .denoiser import FusionMLP, GraphDenoiser2D  # noqa: F401
from .efficientnet import EfficientNetB0Features, MBConv  # noqa: F401
from .gnn import Exophormer, GraphTransformer, TransformerConvLayer, make_gnn  # noqa: F401
from .layers import BatchNorm2D, init_weights  # noqa: F401
from .visual import normalize_patches  # noqa: F401
