"""Graph-attention backbones over padded node arrays — port of the JAX package's ``nn/gnn.py``.

- ``TransformerConvLayer``: out_i = W_skip x_i + Σ_j α_ij W_v x_j over masked edges.
- ``GraphTransformer``: n layers, GELU between them, the last maps to output_size.
- ``Exophormer``: the transformer stack plus V learned virtual global nodes,
  appended as always-valid rows bridging every valid real node and stripped
  before output.

All take ``(x, adj, node_mask)``: x (B, N, D), adj (B, N, N) bool, node_mask (B, N).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import extend_mask_with_virtual_nodes, masked_attention
from .layers import Dense, gelu


class TransformerConvLayer(nn.Module):
    def __init__(self, in_features: int, out_channels: int, heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.out_channels = out_channels
        self.skip = Dense(in_features, out_channels, dtype=dtype)
        self.query = Dense(in_features, out_channels, dtype=dtype)
        self.key = Dense(in_features, out_channels, dtype=dtype)
        self.value = Dense(in_features, out_channels, dtype=dtype)

    def forward(self, x, adj, return_weights: bool = False):
        b, n, _ = x.shape
        h, dh = self.heads, self.out_channels // self.heads
        skip = self.skip(x)
        q = self.query(x).reshape(b, n, h, dh)
        k = self.key(x).reshape(b, n, h, dh)
        v = self.value(x).reshape(b, n, h, dh)
        if return_weights:
            out, w = masked_attention(q, k, v, adj, return_weights=True)
        else:
            out, w = masked_attention(q, k, v, adj), None
        out = skip + out.reshape(b, n, self.out_channels)
        return (out, w) if return_weights else out


class GraphTransformer(nn.Module):
    def __init__(self, in_features: int, hidden_dim: int = 256, heads: int = 8,
                 output_size: int = 256, n_layers: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_features] + [hidden_dim] * (n_layers - 1) + [output_size]
        self.layers = nn.ModuleList(
            TransformerConvLayer(widths[i], widths[i + 1], heads, dtype) for i in range(n_layers)
        )

    def forward(self, x, adj, node_mask, return_weights: bool = False):
        del node_mask  # validity already folded into adj
        for layer in self.layers[:-1]:
            x = gelu(layer(x, adj))
        out = self.layers[-1](x, adj, return_weights=return_weights)
        return out if return_weights else (out, None)


class Exophormer(nn.Module):
    def __init__(self, in_features: int, hidden_dim: int = 256, heads: int = 8,
                 output_size: int = 256, n_layers: int = 4, virt_nodes: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.virt_nodes = virt_nodes
        if virt_nodes > 0:
            self.virt_embedding = nn.Parameter(torch.zeros(virt_nodes, in_features))
        self.transformer = GraphTransformer(in_features, hidden_dim, heads, output_size, n_layers, dtype)

    def forward(self, x, adj, node_mask, return_weights: bool = False):
        b, n, d = x.shape
        if self.virt_nodes > 0:
            virt_rows = self.virt_embedding.to(x.dtype)[None].expand(b, self.virt_nodes, d)
            x = torch.cat([x, virt_rows], dim=1)
            adj, node_mask = extend_mask_with_virtual_nodes(adj, node_mask, self.virt_nodes)
        out, w = self.transformer(x, adj, node_mask, return_weights=return_weights)
        return out[:, :n], w


def make_gnn(
    architecture: str,
    in_features: int,
    output_size: int,
    n_layers: int = 4,
    hidden_dim: int = 256,
    heads: int = 8,
    virt_nodes: int = 4,
    dtype: torch.dtype = torch.float32,
) -> nn.Module:
    """Architecture switch ("transformer" or "exophormer")."""
    if architecture == "transformer":
        return GraphTransformer(in_features, hidden_dim, heads, output_size, n_layers, dtype)
    if architecture == "exophormer":
        return Exophormer(in_features, hidden_dim, heads, output_size, n_layers, virt_nodes, dtype)
    raise ValueError(f"unknown architecture {architecture!r}")
