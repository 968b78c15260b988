"""Pairwise relative-pose pathway for 3D reassembly — port of the JAX
package's ``nn/relpose.py``.

For VN-equivariant part features g_i = M_i f_i and learned channel
projections A_i = g_i U, B_j = g_j V, the bilinear cross terms A_ik B_jkᵀ
transform like the relative rotation M_i M_jᵀ; a confidence-weighted sum of
them regresses it, vectors of type M_i· regress the relative offset
M_i (t_j − t_i), and a pair code from the parts' invariant features gives the
weights and a contact logit. At each sampling step ``rel_consensus`` turns
the neighbours' current pose estimates into hypotheses for each part.

Everything runs in f32 with full-f32 products (TF32 off), as the JAX package
runs it in f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import so3
from .layers import Dense, LayerNorm, gelu


class RelPoseHead(nn.Module):
    """Equivariant pairwise relative-pose head.

    Inputs:  g (B, P, C, 3) equivariant features, inv (B, P, Ci) invariant.
    Outputs: rot_raw (B, P, P, 3, 3) (regresses M_i M_jᵀ), offset
             (B, P, P, 3) (regresses M_i (t_j − t_i)), conf (B, P, P) logits.
    """

    def __init__(self, channels: int, inv_features: int, k: int = 16, hidden: int = 64):
        super().__init__()
        self.hidden = hidden
        self.U = nn.Parameter(torch.zeros(channels, k))
        self.V = nn.Parameter(torch.zeros(channels, k))
        self.inv_ln = LayerNorm(inv_features)
        self.inv_dense = Dense(inv_features, hidden)
        self.pair_dense = Dense(2 * hidden, hidden)
        self.w_rot = Dense(hidden, k)
        self.w_off_a = Dense(hidden, k)
        self.w_off_r = Dense(hidden, k)
        self.conf = Dense(hidden, 1)

    def reference_init(self, normal) -> None:
        """U and V at lecun-normal scale (fan-in C), as the JAX package draws them."""
        for p in (self.U, self.V):
            normal(p, 1.0 / math.sqrt(p.shape[0]))

    def forward(self, g, inv):
        with so3.f32_matmuls():
            b, p = g.shape[:2]
            g = g.float()
            # per-part scale normalisation (a rotation-invariant scalar per part)
            scale = torch.sqrt((g * g).sum(-1).mean(-1) + 1e-8)
            g = g / scale[..., None, None]
            a = torch.einsum("bpcv,ck->bpkv", g, self.U)  # type M_i·
            bm = torch.einsum("bpcv,ck->bpkv", g, self.V)

            e = gelu(self.inv_dense(self.inv_ln(inv.float())))  # (B, P, h)
            h = self.hidden
            pair = torch.cat([e[:, :, None].expand(b, p, p, h), e[:, None, :].expand(b, p, p, h)], dim=-1)
            pair = gelu(self.pair_dense(pair))
            w_rot, w_o1, w_o2 = self.w_rot(pair), self.w_off_a(pair), self.w_off_r(pair)  # (B, P, P, k)
            conf = self.conf(pair)[..., 0]

            rot_raw = torch.einsum("bpkv,bqkw,bpqk->bpqvw", a, bm, w_rot)
            rot_n = normalize_rot(rot_raw)
            offset = (torch.einsum("bpkv,bpqk->bpqv", a, w_o1)
                      + torch.einsum("bpqvw,bqkw,bpqk->bpqv", rot_n, bm, w_o2))
        return rot_raw, offset, conf


def normalize_rot(rot_raw: torch.Tensor) -> torch.Tensor:
    """Scale a near-rotation 3×3 to a rotation's Frobenius norm (√3)."""
    rms = torch.sqrt((rot_raw * rot_raw).mean(dim=(-2, -1), keepdim=True) + 1e-8)
    return rot_raw / (math.sqrt(3.0) * rms)


def split_equiv_inv(feats: torch.Tensor, equiv_dim: int = 768):
    """[equiv(3·C) ‖ inv] features → (g (B, P, C, 3), inv)."""
    b, p = feats.shape[:2]
    return feats[..., :equiv_dim].reshape(b, p, equiv_dim // 3, 3), feats[..., equiv_dim:]


def rel_consensus(rot_raw, offset, conf, x_quat, x_trans, node_mask):
    """Neighbour-triangulated pose hypotheses from the current estimates
    (x_quat (B, P, 4), x_trans (B, P, 3)): (B, P, 13) of [consensus rotation
    (9) ‖ consensus translation (3) ‖ total confidence]."""
    with so3.f32_matmuls():
        b, p = x_quat.shape[:2]
        rot_n = normalize_rot(rot_raw)
        m_hat = so3.quaternion_to_matrix(x_quat)  # (B, P, 3, 3)
        eye = torch.eye(p, dtype=torch.bool, device=node_mask.device)
        pair_valid = (node_mask[:, :, None] & node_mask[:, None, :]) & ~eye
        w = torch.sigmoid(conf) * pair_valid.to(conf.dtype)
        wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
        # rotation hypotheses H_ij = R̂_ij · M̂_j
        hyp = torch.einsum("bpqvw,bqwu->bpqvu", rot_n, m_hat)
        h_cons = torch.einsum("bpq,bpqvu->bpvu", wn, hyp).reshape(b, p, 9)
        # translation hypotheses t_i ≈ t̂_j − M̂_iᵀ ô_ij
        o_world = torch.einsum("bpvw,bpqv->bpqw", m_hat, offset)
        t_hyp = x_trans[:, None, :, :] - o_world
        t_cons = torch.einsum("bpq,bpqv->bpv", wn, t_hyp)
        total_conf = torch.tanh(w.sum(-1, keepdim=True))
    return torch.cat([h_cons, t_cons, total_conf], dim=-1)
