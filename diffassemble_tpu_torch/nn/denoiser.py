"""Graph-attention denoisers — port of the JAX package's ``nn/denoiser.py``.

- ``GraphDenoiser2D``: per node [visual features ‖ pos-MLP(x_t) (32) ‖ time
  embedding (32)] → fusion MLP → graph attention backbone → residual + final
  MLP → output channels. With ``discrete`` x_t is a grid-cell index
  embedded by ``pos_emb`` (plus ``rot_emb`` of the rotation class with
  ``rot_classes``) and the heads give logits: ``final_pos`` (and
  ``final_rot``, then the output is a dict {"pos", "rot"}); the aux head's
  readouts are ``aux_final_pos``/``aux_final_rot``.
- ``GraphDenoiser3D``: the same over point-cloud features, with a LeakyReLU
  fusion MLP, a translation head and an exp-map rotation head (3-vector →
  rotation matrix → unit quaternion, in f32). With ``equiv_inv_mp`` the
  features [equiv (:equiv_dim) ‖ inv] are split before fusion into two
  streams (each with the other's channels zeroed), both fused by the one
  fusion MLP, and the backbone is ``DualStreamGraphTransformer``.

Under tensor parallelism (``parallel/mesh.py:shard_params``) the fusion MLP
is Megatron's pair: ``fc1`` column-parallel behind ``copy_to_tp``, the
activation on the local columns, ``fc2`` row-parallel, its partial products
summed by ``reduce_from_tp`` and its bias added once after the sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import so3
from ..parallel.tensor import TensorParallel, copy_to_tp, reduce_from_tp
from .gnn import DualStreamGraphTransformer, make_gnn
from .layers import Dense, Embed, LayerNorm, gelu


class FusionMLP(nn.Module):
    """Dense → GELU → Dense, or, with ``activation="leaky_relu"`` (the 3D
    model's), Dense → LeakyReLU(0.2) → Dense → LeakyReLU(0.2)."""

    def __init__(self, in_features: int, hidden: int, out: int, dtype: torch.dtype = torch.float32,
                 activation: str = "gelu"):
        super().__init__()
        if activation not in ("gelu", "leaky_relu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.fc1 = Dense(in_features, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out, dtype=dtype)
        self.tp: TensorParallel | None = None  # set by parallel/mesh.py:shard_params

    def forward(self, x):
        act = (lambda y: F.leaky_relu(y, 0.2)) if self.activation == "leaky_relu" else gelu
        if self.tp is None:
            y = self.fc2(act(self.fc1(x)))
        else:
            # the partial products in f32 from the operands in the compute
            # type, summed over the group, the bias added once, rounded once
            # (as one Dense's product with its f32 accumulator)
            dt = self.fc2.compute_dtype
            h = act(self.fc1(copy_to_tp(x, self.tp)))
            y = reduce_from_tp(F.linear(h.float(), self.fc2.weight.to(dt).float()), self.tp)
            y = (y + self.fc2.bias.to(dt).float()).to(dt)
        return F.leaky_relu(y, 0.2) if self.activation == "leaky_relu" else y


class _GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


def _head(in_features: int, hidden: int, out: int, dtype: torch.dtype) -> nn.Sequential:
    """Dense → GELU → Dense, indexed 0 and 2 (the GELU sits at 1)."""
    return nn.Sequential(Dense(in_features, hidden, dtype=dtype), _GELU(), Dense(hidden, out, dtype=dtype))


class GraphDenoiser2D(nn.Module):
    """2D piece-pose denoiser over padded graphs.

    Inputs:  x_t (B, N, Cin) noisy poses (with ``discrete``: (B, N) int cell
             indices, and rot_t (B, N) int rotation classes with
             ``rot_classes``), t (B, N) int timesteps, feats (B, N, F)
             per-piece visual features, adj (B, N, N) bool mask, node_mask
             (B, N) bool.
    Output:  (B, N, Cout) — the ε or x₀ prediction in the compute type; with
             ``discrete`` the (B, N, n_classes) position logits, or with
             ``rot_classes`` the dict {"pos", "rot"} of logits.
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
        discrete: bool = False,
        n_classes: int = 0,
        rot_classes: int = 0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.two_heads = two_heads
        self.discrete, self.rot_classes = discrete, rot_classes
        combined_dim = feature_dim + 32 + 32
        self.time_emb = Embed(steps, 32, dtype=dtype)
        if discrete:
            self.pos_emb = Embed(n_classes, 32, dtype=dtype)
            if rot_classes:
                self.rot_emb = Embed(rot_classes, 32, dtype=dtype)
        else:
            self.pos_mlp = _head(input_channels, 16, 32, dtype)
        self.fusion = FusionMLP(combined_dim, 128, combined_dim, dtype)
        if aux_head:
            # feats-only readout for training; its parameters exist in the
            # checkpoint, sampling does not run it
            self.aux_ln0 = LayerNorm(feature_dim, dtype)
            self.aux_final_0 = Dense(feature_dim, 128, dtype=dtype)
            self.aux_ln1 = LayerNorm(128, dtype)
            if discrete:
                self.aux_final_pos = Dense(128, n_classes, dtype=dtype)
                if rot_classes:
                    self.aux_final_rot = Dense(128, rot_classes, dtype=dtype)
            else:
                self.aux_final_1 = Dense(128, output_channels, dtype=dtype)
        self.aux_head = aux_head
        self.gnn = make_gnn(architecture, combined_dim, combined_dim, n_layers, hidden_dim,
                            heads, virt_nodes, dtype)
        if discrete:
            self.final_pos = _head(combined_dim, 64, n_classes, dtype)
            if rot_classes:
                self.final_rot = _head(combined_dim, 32, rot_classes, dtype)
        elif two_heads:
            self.final_t = _head(combined_dim, 32, 2, dtype)
            self.final_r = _head(combined_dim, 32, output_channels - 2, dtype)
        else:
            self.final = _head(combined_dim, 32, output_channels, dtype)

    def forward(self, x_t, t, feats, adj, node_mask, rot_t=None, return_attentions: bool = False,
                return_aux: bool = False):
        time_feats = self.time_emb(t)
        if self.discrete:
            pos_feats = self.pos_emb(x_t)
            if self.rot_classes:
                pos_feats = pos_feats + self.rot_emb(rot_t)
        else:
            pos_feats = self.pos_mlp(x_t)
        combined = torch.cat([feats.to(self.compute_dtype), pos_feats, time_feats], dim=-1)
        combined = self.fusion(combined)

        aux_out = None
        if return_aux:
            if not self.aux_head:
                raise ValueError("return_aux needs a denoiser built with aux_head=True")
            a = gelu(self.aux_ln1(self.aux_final_0(self.aux_ln0(feats.to(self.compute_dtype)))))
            if self.discrete:
                aux_out = {"pos": self.aux_final_pos(a)}
                if self.rot_classes:
                    aux_out["rot"] = self.aux_final_rot(a)
            else:
                aux_out = self.aux_final_1(a)

        h, attentions = self.gnn(combined, adj, node_mask, return_weights=return_attentions)
        resid = h + combined
        if self.discrete:
            out = {"pos": self.final_pos(resid), "rot": self.final_rot(resid)} if self.rot_classes \
                else self.final_pos(resid)
        elif self.two_heads:
            out = torch.cat([self.final_t(resid), self.final_r(resid)], dim=-1)
        else:
            out = self.final(resid)
        if return_aux:
            return (out, attentions, aux_out) if return_attentions else (out, aux_out)
        if return_attentions:
            return out, attentions
        return out


class GraphDenoiser3D(nn.Module):
    """SE(3) fragment-pose denoiser.

    Inputs: x_t (B, P, 7) [quat ‖ trans] (13 with ``use_6dof``), t (B, P) int,
            feats (B, P, F) point-cloud features, adj (B, P, P) bool,
            node_mask (B, P), and with ``rel_channels`` the consensus vector
            rel_ctx (B, P, rel_channels).
    Output: (B, P, 7) f32 [unit quat ‖ trans] (13 with ``use_6dof``: the
            translation head carries [trans (3) ‖ 6-DoF (6)]).
    """

    def __init__(
        self,
        steps: int,
        input_channels: int = 7,
        feature_dim: int = 768,
        n_layers: int = 4,
        architecture: str = "transformer",
        virt_nodes: int = 8,
        hidden_dim: int = 256,
        heads: int = 8,
        use_6dof: bool = False,
        equiv_inv_mp: bool = False,
        equiv_dim: int = 768,
        rel_channels: int = 0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if equiv_inv_mp and architecture != "transformer":
            raise ValueError("equiv_inv_mp requires architecture='transformer'")
        self.equiv_inv_mp, self.equiv_dim = equiv_inv_mp, equiv_dim
        self.rel_channels = rel_channels
        combined_dim = feature_dim + 32 + 32
        self.time_emb = Embed(steps, 32, dtype=dtype)
        # a wider pose MLP when the 13-channel consensus vector rides along
        self.pos_mlp = _head(input_channels + rel_channels, 48 if rel_channels else 16, 32, dtype)
        self.fusion = FusionMLP(combined_dim, 256, combined_dim, dtype, activation="leaky_relu")
        if equiv_inv_mp:
            self.gnn = DualStreamGraphTransformer(combined_dim, hidden_dim, heads, combined_dim, n_layers, dtype)
        else:
            self.gnn = make_gnn(architecture, combined_dim, combined_dim, n_layers, hidden_dim, heads,
                                virt_nodes, dtype)
        self.mlp_t = _head(combined_dim, 256, 9 if use_6dof else 3, dtype)
        self.mlp_r = _head(combined_dim, 256, 3, dtype)

    def forward(self, x_t, t, feats, adj, node_mask, rel_ctx=None, return_attentions: bool = False):
        time_feats = self.time_emb(t)
        if self.rel_channels:
            x_t = torch.cat([x_t, rel_ctx.to(x_t.dtype)], dim=-1)
        pos_feats = self.pos_mlp(x_t)
        f = feats.to(time_feats.dtype)
        if self.equiv_inv_mp:
            # split before fusion, where the [equiv ‖ inv] channel layout is real
            equiv = torch.arange(f.shape[-1], device=f.device) < self.equiv_dim
            f_e, f_i = torch.where(equiv, f, 0), torch.where(equiv, 0, f)
            combined = self.fusion(torch.cat([f_e, pos_feats, time_feats], dim=-1))
            combined_i = self.fusion(torch.cat([f_i, pos_feats, time_feats], dim=-1))
            h, attentions = self.gnn(combined, combined_i, adj, node_mask, return_weights=return_attentions)
        else:
            combined = self.fusion(torch.cat([f, pos_feats, time_feats], dim=-1))
            h, attentions = self.gnn(combined, adj, node_mask, return_weights=return_attentions)
        resid = h + combined
        t_pred = self.mlp_t(resid)
        r_vec = self.mlp_r(resid)
        r_quat = so3.matrix_to_quaternion(so3.rotvec_to_rmat(r_vec.float()))
        out = torch.cat([r_quat, t_pred.float()], dim=-1)
        return (out, attentions) if return_attentions else out
