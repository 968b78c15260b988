"""2D graph-attention denoiser — port of the JAX package's ``nn/denoiser.py:34-183``
(continuous mode).

Per node: [visual features ‖ pos-MLP(x_t) (32) ‖ time embedding (32)] → fusion
MLP → graph attention backbone → residual + final MLP → output channels.
"""

from __future__ import annotations

import torch
from torch import nn

from .gnn import make_gnn
from .layers import Dense, Embed, LayerNorm, gelu


class FusionMLP(nn.Module):
    """Dense → GELU → Dense."""

    def __init__(self, in_features: int, hidden: int, out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out, dtype=dtype)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class _GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


def _head(in_features: int, hidden: int, out: int, dtype: torch.dtype) -> nn.Sequential:
    """Dense → GELU → Dense, indexed 0 and 2 (the GELU sits at 1)."""
    return nn.Sequential(Dense(in_features, hidden, dtype=dtype), _GELU(), Dense(hidden, out, dtype=dtype))


class GraphDenoiser2D(nn.Module):
    """2D piece-pose denoiser over padded graphs.

    Inputs:  x_t (B, N, Cin) noisy poses, t (B, N) int timesteps, feats
             (B, N, F) per-piece visual features, adj (B, N, N) bool mask,
             node_mask (B, N) bool.
    Output:  (B, N, Cout) — the ε or x₀ prediction in the compute type.
    """

    def __init__(
        self,
        steps: int,
        input_channels: int = 2,
        output_channels: int = 2,
        feature_dim: int = 1088,
        n_layers: int = 4,
        architecture: str = "transformer",
        virt_nodes: int = 4,
        hidden_dim: int = 256,
        heads: int = 8,
        two_heads: bool = False,
        aux_head: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.two_heads = two_heads
        combined_dim = feature_dim + 32 + 32
        self.time_emb = Embed(steps, 32, dtype=dtype)
        self.pos_mlp = _head(input_channels, 16, 32, dtype)
        self.fusion = FusionMLP(combined_dim, 128, combined_dim, dtype)
        if aux_head:
            # feats-only readout for training; its parameters exist in the
            # checkpoint, sampling does not run it
            self.aux_ln0 = LayerNorm(feature_dim, dtype)
            self.aux_final_0 = Dense(feature_dim, 128, dtype=dtype)
            self.aux_ln1 = LayerNorm(128, dtype)
            self.aux_final_1 = Dense(128, output_channels, dtype=dtype)
        self.aux_head = aux_head
        self.gnn = make_gnn(architecture, combined_dim, combined_dim, n_layers, hidden_dim,
                            heads, virt_nodes, dtype)
        if two_heads:
            self.final_t = _head(combined_dim, 32, 2, dtype)
            self.final_r = _head(combined_dim, 32, output_channels - 2, dtype)
        else:
            self.final = _head(combined_dim, 32, output_channels, dtype)

    def forward(self, x_t, t, feats, adj, node_mask, return_attentions: bool = False,
                return_aux: bool = False):
        time_feats = self.time_emb(t)
        pos_feats = self.pos_mlp(x_t)
        combined = torch.cat([feats.to(self.compute_dtype), pos_feats, time_feats], dim=-1)
        combined = self.fusion(combined)

        aux_out = None
        if return_aux:
            if not self.aux_head:
                raise ValueError("return_aux needs a denoiser built with aux_head=True")
            a = self.aux_final_0(self.aux_ln0(feats.to(self.compute_dtype)))
            aux_out = self.aux_final_1(gelu(self.aux_ln1(a)))

        h, attentions = self.gnn(combined, adj, node_mask, return_weights=return_attentions)
        resid = h + combined
        if self.two_heads:
            out = torch.cat([self.final_t(resid), self.final_r(resid)], dim=-1)
        else:
            out = self.final(resid)
        if return_aux:
            return (out, attentions, aux_out) if return_attentions else (out, aux_out)
        if return_attentions:
            return out, attentions
        return out
