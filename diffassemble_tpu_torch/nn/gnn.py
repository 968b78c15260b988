"""Graph-attention backbones over padded node arrays — port of the JAX package's ``nn/gnn.py``.

- ``TransformerConvLayer``: out_i = W_skip x_i + Σ_j α_ij W_v x_j over masked edges.
- ``GraphTransformer``: n layers, GELU between them, the last maps to output_size.
- ``Exophormer``: the transformer stack plus V learned virtual global nodes,
  appended as always-valid rows bridging every valid real node and stripped
  before output.
- ``GCN``: two GCNConv layers over the self-looped, degree-normalised
  adjacency (matrix products, no attention; it returns no weights).
- ``DualStreamGraphTransformer``: equivariant/invariant split message
  passing over two feature streams through one set of weights per layer
  (``_DualConvLayer``): the equivariant stream's queries and skip attend to
  keys and values of the invariant stream, and the invariant stream advances
  by the skip projection alone. It equals duplicating every node and
  redirecting the edges' sources onto the copies, without doubling N.

All take ``(x, adj, node_mask)``: x (B, N, D), adj (B, N, N) bool, node_mask (B, N).

Under tensor parallelism (``parallel/mesh.py:shard_params`` sets a
``TransformerConvLayer``'s ``tp``) a layer holds its group's share of the
heads: the four projections are column-parallel (``copy_to_tp`` on x and on
``kv``), attention runs over H/tp heads on the shared mask, and
``gather_from_tp`` makes the layer's output whole. The rest of every
backbone runs replicated (the Exophormer's virtual rows too; the GCN holds no
sharded parameter).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import extend_mask_with_virtual_nodes, masked_attention
from ..parallel.tensor import TensorParallel, copy_to_tp, gather_from_tp
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
        self.tp: TensorParallel | None = None  # set by parallel/mesh.py:shard_params

    def forward(self, x, adj, return_weights: bool = False, kv=None, skip_only: bool = False):
        """``kv`` gives the keys' and values' stream (queries and skip still
        come from x); ``skip_only`` applies the skip projection alone."""
        b, n, _ = x.shape
        tp = self.tp
        share = 1 if tp is None else tp.size
        h, dh, c = self.heads // share, self.out_channels // self.heads, self.out_channels // share
        if tp is not None:
            x = copy_to_tp(x, tp)
            kv = None if kv is None else copy_to_tp(kv, tp)
        skip = self.skip(x)
        if skip_only:
            return skip if tp is None else gather_from_tp(skip, tp)
        src = x if kv is None else kv
        q = self.query(x).reshape(b, n, h, dh)
        k = self.key(src).reshape(b, n, h, dh)
        v = self.value(src).reshape(b, n, h, dh)
        if return_weights:
            out, w = masked_attention(q, k, v, adj, return_weights=True)
        else:
            out, w = masked_attention(q, k, v, adj), None
        out = skip + out.reshape(b, n, c)
        if tp is not None:
            out = gather_from_tp(out, tp)
            w = None if w is None else gather_from_tp(w, tp, dim=1)
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


class _DualConvLayer(nn.Module):
    """One split-message-passing layer: one ``TransformerConvLayer`` applied
    to both streams."""

    def __init__(self, in_features: int, out_channels: int, heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = TransformerConvLayer(in_features, out_channels, heads, dtype)

    def forward(self, x_e, x_i, adj):
        return self.conv(x_e, adj, kv=x_i), self.conv(x_i, adj, skip_only=True)


class DualStreamGraphTransformer(nn.Module):
    """n_layers of split message passing, GELU on both streams between
    layers; the last layer maps the equivariant stream to output_size with
    keys and values from the invariant one."""

    def __init__(self, in_features: int, hidden_dim: int = 256, heads: int = 8,
                 output_size: int = 256, n_layers: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_features] + [hidden_dim] * (n_layers - 1) + [output_size]
        self.layers = nn.ModuleList(
            [_DualConvLayer(widths[i], widths[i + 1], heads, dtype) for i in range(n_layers - 1)]
            + [TransformerConvLayer(widths[-2], widths[-1], heads, dtype)])

    def forward(self, x_e, x_i, adj, node_mask, return_weights: bool = False):
        del node_mask  # validity already folded into adj
        for layer in self.layers[:-1]:
            x_e, x_i = layer(x_e, x_i, adj)
            x_e, x_i = gelu(x_e), gelu(x_i)
        out = self.layers[-1](x_e, adj, kv=x_i, return_weights=return_weights)
        return out if return_weights else (out, None)


class GCN(nn.Module):
    """Two GCNConv layers (the reference's GCN baseline): the adjacency with
    self loops, symmetrically normalised by the degrees, times a Dense layer
    of the nodes, ReLU between the two. Plain matrix products: no attention,
    so it returns no weights."""

    def __init__(self, in_features: int, hidden_dim: int = 256, output_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, output_size, dtype=dtype)
        self.compute_dtype = dtype

    @staticmethod
    def norm_adj(adj: torch.Tensor) -> torch.Tensor:
        """D^-1/2 max(A, I) D^-1/2 in f32 for (B, N, N) ``adj``, 0 where a degree is 0."""
        a = torch.maximum(adj.float(), torch.eye(adj.shape[-1], device=adj.device)[None])
        deg = a.sum(-1)
        dinv = torch.where(deg > 0, 1.0 / torch.sqrt(deg), 0.0)
        return a * dinv[:, :, None] * dinv[:, None, :]

    def forward(self, x, adj, node_mask, return_weights: bool = False):
        del node_mask  # validity already folded into adj
        a = self.norm_adj(adj).to(self.compute_dtype)
        x = torch.relu(a @ self.fc1(x))
        return a @ self.fc2(x), None


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
    """Architecture switch ("transformer", "gcn" or "exophormer")."""
    if architecture == "transformer":
        return GraphTransformer(in_features, hidden_dim, heads, output_size, n_layers, dtype)
    if architecture == "gcn":
        return GCN(in_features, hidden_dim, output_size, dtype)
    if architecture == "exophormer":
        return Exophormer(in_features, hidden_dim, heads, output_size, n_layers, virt_nodes, dtype)
    raise ValueError(f"unknown architecture {architecture!r}")
