"""Correspondence-level relative pose by cross-attention point matching —
port of the JAX package's ``nn/correspondence.py``.

Points of every ordered part pair (i, j) are soft-matched by
rotation-invariant per-point descriptors (``CorrespondencePairs``); the
relative pose is read off the matched coordinates by a weighted Kabsch solve
(``solve_rel_poses``). Part clouds are in centred local frames: a canonical
point X appears in part i as p_i = M_i (X − t_i), so mated points obey
p_i = R_ij p_j + o_ij with R_ij = M_i M_jᵀ and o_ij = M_i (t_j − t_i), the
targets of ``models/losses_3d.relative_pose_targets``.

Training supervises the matches (``correspondence_rel_loss``) and the
attention itself (``correspondence_attention_loss``), never the SVD's
output; the Kabsch solve is for evaluation. Products run in full f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..models.losses_3d import relative_pose_targets, transform_pc
from ..ops.so3 import f32_matmuls
from .layers import Dense, LayerNorm


def weighted_kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """dst ≈ R·src + o in the weighted least-squares sense: src, dst
    (..., m, 3), w (..., m) ≥ 0 → R (..., 3, 3) a proper rotation, o (..., 3)."""
    with f32_matmuls():
        wn = w / (w.sum(-1, keepdim=True) + 1e-9)
        src_c = (wn[..., None] * src).sum(-2, keepdim=True)
        dst_c = (wn[..., None] * dst).sum(-2, keepdim=True)
        h = torch.einsum("...m,...mi,...mj->...ij", wn, src - src_c, dst - dst_c)
        u, _, vt = torch.linalg.svd(h)
        v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
        det = torch.linalg.det(v @ ut)
        d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
        r = torch.einsum("...ij,...j,...kj->...ik", v, d, u)  # V diag(1, 1, det) Uᵀ
        o = dst_c[..., 0, :] - torch.einsum("...ij,...j->...i", r, src_c[..., 0, :])
    return r, o


class CorrespondencePairs(nn.Module):
    """Soft point correspondences for every ordered part pair (i, j).

    Inputs: pts (B, P, n, 3) part clouds in their local frames, desc (B, P,
    n, D) per-point rotation-invariant descriptors. Returns a dict: y (B, P,
    P, m, 3) for each of part i's first m points the soft match read from
    part j's points (in j's frame), p (B, P, m, 3) those query points, w (B,
    P, P, m) each match's weight (query saliency × match sharpness), conf (B,
    P, P) a contact logit per pair, att (B, P, P, m, m) the matching
    attention. Matching sees descriptors only, so it is invariant to either
    part's rotation while y and p move with their frames."""

    def __init__(self, desc_dim: int, d_model: int = 64, m_points: int = 128):
        super().__init__()
        self.d_model, self.m_points = d_model, m_points
        self.norm = LayerNorm(desc_dim)
        self.q = Dense(desc_dim, d_model)
        self.k = Dense(desc_dim, d_model)
        self.saliency = Dense(desc_dim, 1)
        self.conf = Dense(1, 1)

    def reference_init(self, normal) -> None:
        """The JAX package's: lecun-normal kernels, zero biases but the
        contact logit's, -1 (no contact by default)."""
        for dense in (self.q, self.k, self.saliency, self.conf):
            normal(dense.weight, 1.0 / math.sqrt(dense.weight.shape[1]))
            dense.bias.zero_()
        self.conf.bias.fill_(-1.0)
        self.norm.weight.fill_(1.0)
        self.norm.bias.zero_()

    def forward(self, pts, desc):
        m = min(self.m_points, pts.shape[2])
        # the input point order is random by construction, so a prefix is an unbiased subsample
        pts_m = pts[:, :, :m].float()
        h = self.norm(desc[:, :, :m].float())
        q, k = self.q(h), self.k(h)
        sal = self.saliency(h)[..., 0]  # (B, P, m)
        with f32_matmuls():
            logits = torch.einsum("bpad,bqcd->bpqac", q, k) / math.sqrt(self.d_model)
            att = torch.softmax(logits, dim=-1)
            y = torch.einsum("bpqac,bqcv->bpqav", att, pts_m)
        sharp = att.amax(dim=-1)  # (B, P, P, m) how peaked each match is
        w = torch.sigmoid(sal)[:, :, None, :] * sharp
        conf = self.conf(w.mean(dim=-1, keepdim=True))[..., 0]
        return {"y": y, "p": pts_m, "w": w, "conf": conf, "att": att}


def correspondence_attention_loss(out, gt_q, gt_t, contact, valids, sigma: float = 0.05, eps_row: float = 0.1):
    """Cross-entropy of each contact pair's attention rows against the true
    matching: a target ∝ exp(−d²/2σ²) over j's points by canonical-space
    distance d, on the query points of i with a mate on j within ``eps_row``."""
    del valids
    att, p = out["att"], out["p"]
    q_conj = gt_q * torch.tensor([1.0, -1.0, -1.0, -1.0], device=gt_q.device)
    canon = transform_pc(gt_t, q_conj, p)  # (B, P, m, 3)
    sq = (canon * canon).sum(-1)
    with f32_matmuls():
        cross = torch.einsum("bpav,bqcv->bpqac", canon, canon)
    d2 = torch.clamp(sq[:, :, None, :, None] + sq[:, None, :, None, :] - 2.0 * cross, min=0.0)
    target = torch.softmax(-d2 / (2.0 * sigma * sigma), dim=-1)
    row_ok = d2.amin(dim=-1) < eps_row * eps_row  # (B, P, P, m)
    c = contact.float()[..., None] * row_ok.float()
    ce = -(target * torch.log(att + 1e-9)).sum(-1)
    return (c * ce).sum() / torch.clamp(c.sum(), min=1.0)


def correspondence_rel_loss(out, gt_q, gt_t, contact, valids) -> dict:
    """Matches on contact pairs: w·‖R_gt·y + o_gt − p‖², a log barrier
    keeping the mean weight off 0, and the BCE of the contact logit over
    valid i ≠ j pairs."""
    r_gt, o_gt = relative_pose_targets(gt_q, gt_t)
    y, p, w, conf = out["y"], out["p"], out["w"], out["conf"]
    with f32_matmuls():
        y_in_i = torch.einsum("bpqvc,bpqac->bpqav", r_gt, y) + o_gt[:, :, :, None, :]
    res = ((y_in_i - p[:, :, None]) ** 2).sum(-1)  # (B, P, P, m)
    c = contact.float()
    denom = torch.clamp(c.sum(), min=1.0)
    wsum = w.sum(-1) + 1e-6
    match_l = (c * (w * res).sum(-1) / wsum).sum() / denom
    mass_l = (c * -torch.log(w.mean(-1) + 1e-6)).sum() / denom * 0.01
    eye = torch.eye(conf.shape[-1], dtype=torch.bool, device=conf.device)
    pvf = (valids[:, :, None].bool() & valids[:, None, :].bool() & ~eye).float()
    bce = torch.clamp(conf, min=0.0) - conf * c + torch.log1p(torch.exp(-conf.abs()))
    conf_l = (pvf * bce).sum() / torch.clamp(pvf.sum(), min=1.0)
    return {"corr_match_loss": match_l, "corr_mass_loss": mass_l, "corr_conf_loss": conf_l}


def solve_rel_poses(out):
    """R (B, P, P, 3, 3), o (B, P, P, 3) with p_i ≈ R·y + o: the (R_ij,
    o_ij) of ``relative_pose_targets``, by weighted Kabsch over the soft
    matches."""
    y, p, w = out["y"], out["p"], out["w"]
    return weighted_kabsch(y, p[:, :, None].expand(y.shape), w)
