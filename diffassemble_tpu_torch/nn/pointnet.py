"""Point-cloud encoder switch — port of the JAX package's
``nn/pointnet.py:make_point_encoder``.

The VN-DGCNN rows are built (``nn/vn.py``); the PointNet encoders
(``pointnet``, ``pointnet_inv``, ``pointnet_plus``) and the VN-PointNet
(``vnn``) are ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import torch
from torch import nn

from .vn import VN_DGCNN

_NOT_PORTED = ("pointnet", "pointnet_inv", "pointnet_plus", "vnn")


def make_point_encoder(name: str, dtype: torch.dtype = torch.float32) -> tuple[nn.Module, int]:
    """(encoder, output dim) for a backbone name, as the JAX package's table has them."""
    table = {
        "vn_dgcnn": (lambda: VN_DGCNN(feat_dim=128, dtype=dtype), 768),
        "vn_dgcnn_inv": (lambda: VN_DGCNN(feat_dim=128, invariant=True, dtype=dtype), 256),
        # [equiv(768) ‖ inv(256)]: the layout of the relative-pose pathway
        "vn_dgcnn_equiv_inv": (lambda: VN_DGCNN(feat_dim=128, both=True, dtype=dtype), 1024),
        # [equiv(1536) ‖ inv(512)]: mean ‖ soft max-norm pooling
        "vn_dgcnn_rich": (lambda: VN_DGCNN(feat_dim=128, both=True, pool="mean_maxnorm", dtype=dtype), 2048),
    }
    if name in _NOT_PORTED:
        raise NotImplementedError(f"point backbone {name!r} is not ported yet: ROADMAP Queue 1 item 15")
    if name not in table:
        raise ValueError(f"unknown point backbone {name!r}")
    fn, dim = table[name]
    return fn(), dim
