"""Masked multi-head graph attention over padded node arrays.

Port of the JAX package's ``ops/attention.py``. Graphs are padded (B, N, D)
node arrays and every topology (fully connected, random expander, virtual
global nodes) is a (B, N, N) boolean mask:

  out_i = Σ_j softmax_j((q_i · k_j)/√d) v_j   over j with adj[b, i, j]

Dispatch (``masked_attention``): a CUDA tensor goes through
``MaskedAttention`` (``ops/cuda_attention.py``), whose forward and backward
are the hand-written kernels, at every N; a CPU tensor, or a call that asks
for the weights (visualisation only), goes to the plain version below, which
autograd differentiates. The JAX
package's padding wrapper (``_pallas_masked_attention``) permutes to
(B, H, N, Dh) and pads N to the 128-row block; the CUDA kernel reads the
(B, N, H, Dh) layout as it is and masks the ragged last tile itself, which is
the same as padding with masked rows, so no copy is made.
"""

from __future__ import annotations

import torch

from .cuda_attention import MaskedAttention

_NEG_INF = -1e9


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    adj: torch.Tensor,
    return_weights: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Multi-head attention restricted to graph edges.

    Args:
        q, k, v: (B, N, H, Dh).
        adj: (B, N, N) bool — adj[b, i, j] True ⇒ node i may attend to node j.
        return_weights: also return the (B, H, N, N) f32 attention weights.

    Returns:
        (B, N, H, Dh) attended values; rows with no edges at all return zeros.
    """
    if q.is_cuda and not return_weights:
        return MaskedAttention.apply(q, k, v, adj)
    return _plain_masked_attention(q, k, v, adj, return_weights)


def _plain_masked_attention(q, k, v, adj, return_weights):
    """The JAX package's XLA path: scores in the input type, −1e9 fill, f32
    softmax, zero rows for nodes with no edges."""
    dh = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(dh, dtype=torch.float32, device=q.device))
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k).float() * scale
    scores = torch.where(adj[:, None], scores, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    any_edge = adj.any(dim=-1)  # (B, N)
    weights = weights * any_edge[:, None, :, None].to(weights.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", weights.to(v.dtype), v)
    if return_weights:
        return out, weights
    return out


def build_adjacency_mask(edge_mask: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Combine a topology mask (N, N) or (B, N, N) with node validity (B, N):
    edge present AND both endpoints valid → (B, N, N)."""
    if edge_mask.dim() == 2:
        edge_mask = edge_mask[None]
    pair_valid = node_mask[:, :, None] & node_mask[:, None, :]
    return edge_mask & pair_valid


def fully_connected_mask(n: int, self_loops: bool = True, device: torch.device | str = "cpu") -> torch.Tensor:
    """Dense topology over n nodes."""
    m = torch.ones((n, n), dtype=torch.bool, device=device)
    if not self_loops:
        m &= ~torch.eye(n, dtype=torch.bool, device=device)
    return m


def extend_mask_with_virtual_nodes(
    adj: torch.Tensor, node_mask: torch.Tensor, n_virtual: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Append always-valid virtual global nodes bridging every valid real node;
    virtual nodes also see each other.

    adj (B, N, N), node_mask (B, N) → ((B, N+V, N+V), (B, N+V)).
    """
    b, n, _ = adj.shape
    v = n_virtual
    full = torch.zeros((b, n + v, n + v), dtype=torch.bool, device=adj.device)
    full[:, :n, :n] = adj
    full[:, :n, n:] = node_mask[:, :, None]
    full[:, n:, :n] = node_mask[:, None, :]
    full[:, n:, n:] = True
    ext_node_mask = torch.cat(
        [node_mask, torch.ones((b, v), dtype=torch.bool, device=adj.device)], dim=1
    )
    return full, ext_node_mask
