"""The float32 tensor-core forward's operand rounding, emulated on the CPU.

``csrc/masked_attention_fwd_tc_f32.cu`` computes S = q·kᵀ and P̃·V on the
tensor cores with TF32 operands (10 explicit mantissa bits). Each f32 operand
x is split into hi = tf32(x) and lo = tf32(x − hi), rounded to nearest with
ties away from zero as ``cvt.rna.tf32.f32`` rounds, and lo·hi + hi·lo + hi·hi
are summed (3xTF32). The emulation follows the kernel step for step: key
tiles of the kernel's size per head width, a running max from −1e9 over the
edges only, the unnormalised p̃ = exp(S − m) in f32 (split like any operand
before P·V), O ← alpha·O + P̃·V per tile, O = acc / max(l, 1e−30) and
L = m + log(max(l, 1e−30)). The products of the halves are summed by torch's
f32 ``einsum``: this does not model how the tensor cores accumulate
(``chip_smoke.py --only f32_rounding`` sets the kernel beside emulations of
that on the card, and ``test_torch_cuda.py`` holds the kernel itself to the
plain version). Here it is held to the card's f32 forward gate against the
plain version (``chip_smoke.py:_check_kernels``) at the serving path's
shape, and to the JAX package's Pallas forward in interpret mode at
``test_torch_attention.py``'s small shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention import TOL, _inputs
from test_torch_attention_bwd_f32 import tf32

from diffassemble_tpu.ops.pallas_attention import _flash_fwd
from diffassemble_tpu_torch.data.expander import expander_mask
from diffassemble_tpu_torch.ops import attention as tattn
from diffassemble_tpu_torch.ops import cuda_attention as ca

KEY_TILE = {32: 64, 144: 16}  # key_tile(DH) in csrc/masked_attention_fwd_tc_f32.cu
EMPTY_ROWS = slice(1, 4)  # query rows with no edges
UNATTENDED = slice(5, 8)  # keys no query attends


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads: the suite runs several test processes on one
    machine, and more threads than cores make torch's CPU kernels spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fwd_tc_f32_emulation(q, k, v, mask, passes: int = 3):
    """O and L (f32) with the operands rounded as the f32 tensor-core forward
    rounds them: the two operands of S = q·kᵀ and of P̃·V split into TF32
    halves, the products of the halves (3 passes: lo·hi, hi·lo, hi·hi; 1
    pass: hi·hi) summed by f32 ``einsum``s; the online softmax over the
    kernel's key tiles, a masked entry never exponentiated."""

    def product(eq, a, b):
        a_hi, b_hi = tf32(a), tf32(b)
        if passes == 1:
            return torch.einsum(eq, a_hi, b_hi)
        a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
        return torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_hi, b_hi)

    key_tile = KEY_TILE[q.shape[-1]]
    s = product("bnhd,bmhd->bhnm", q, k) * (1.0 / np.sqrt(q.shape[-1]))
    edges = mask.bool()[:, None]  # (B, 1, N, N)
    b, h, n, _ = s.shape
    m = torch.full((b, h, n), -1e9)
    l = torch.zeros((b, h, n))
    acc = torch.zeros((b, h, n, q.shape[-1]))
    for k0 in range(0, n, key_tile):
        st, et = s[..., k0:k0 + key_tile], edges[..., k0:k0 + key_tile]
        m_new = torch.maximum(m, torch.where(et, st, -1e9).amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(et, torch.exp(st - m_new[..., None]), 0.0)  # a masked entry is never exponentiated
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + product("bhnm,bmhd->bhnd", p, v[:, k0:k0 + key_tile])
        m = m_new
    denom = l.clamp_min(1e-30)
    return (acc / denom[..., None]).transpose(1, 2), m + torch.log(denom)


def _worst(o, lse, o_p, l_p, v, adj):
    """The card's f32 forward gate against the plain version: the worst
    error/tolerance of O (1e-5 relative plus 1e-5 of max|v|) and of L
    (1e-5 of 1 + |L|) on the rows with an edge."""
    tol = 1e-5 * o_p.abs() + 1e-5 * v.abs().max()
    nonempty = adj.any(-1)[:, None, :].expand_as(lse)
    l_tol = 1e-5 * (1 + l_p.abs()[nonempty])
    return float(((o - o_p).abs() / tol).max()), float(((lse - l_p).abs()[nonempty] / l_tol).max())


@pytest.mark.parametrize("dh", [32, 144])
def test_3xtf32_forward_holds_the_f32_gate_and_one_tf32_pass_breaks_it(dh):
    """At the serving path's shape (B = 1, H = 8, N = 908, the 10% expander
    plus 8 virtual nodes, three empty query rows and three keys no query
    attends) with randn f32 inputs, 3xTF32 holds the f32 forward gate: worst
    error/tolerance of O 0.016 at Dh 32 and 0.031 at Dh 144 here, of L 0.016
    at both; one TF32 product (hi·hi) breaks it, O by 16.5x and 12.2x, L by
    7.8x and 4.5x: the reason for three. Empty rows give O = 0 exactly and
    the plain version's L bit for bit."""
    rng = np.random.default_rng(200 + dh)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 908, 8, dh)).astype(np.float32)) for _ in range(3))
    topo = torch.as_tensor(expander_mask(900, "10%", np.random.default_rng(0)))
    node_mask = torch.ones((1, 900), dtype=torch.bool)
    adj, _ = tattn.extend_mask_with_virtual_nodes(tattn.build_adjacency_mask(topo, node_mask), node_mask, 8)
    adj[0, EMPTY_ROWS] = False
    adj[0, :, UNATTENDED] = False
    o_p, l_p = ca.masked_attention_fwd_plain(q, k, v, adj)
    o, lse = _fwd_tc_f32_emulation(q, k, v, adj)
    assert o.dtype == torch.float32 and o.shape == q.shape and lse.shape == l_p.shape
    three = _worst(o, lse, o_p, l_p, v, adj)
    assert max(three) <= 0.1, three
    one = _worst(*_fwd_tc_f32_emulation(q, k, v, adj, passes=1), o_p, l_p, v, adj)
    assert min(one) > 1.0, one
    empty, unattended = ~adj.any(-1), ~adj.any(-2)
    assert bool(empty[0, EMPTY_ROWS].all()) and bool(unattended[0, UNATTENDED].all())
    assert int(empty.sum()) == 3 and bool((o[empty] == 0).all())
    rows = empty[:, None, :].expand_as(lse)
    assert torch.equal(lse[rows], l_p[rows])


@pytest.mark.parametrize("n, dh", [(200, 32), (200, 144), (256, 32), (256, 144)])
def test_3xtf32_forward_matches_pallas_forward(n, dh):
    """O and L of the emulation against the Pallas kernel in interpret mode
    at ``test_torch_attention.py``'s shapes and tolerance (N padded to the
    Pallas kernel's 128-row block, padding rows and rows with no edges),
    the main paths' widths, which the f32 tensor-core forward takes."""
    q, k, v, adj = _inputs(2, n, 2, dh, seed=3 * n + dh)
    n_pad = -(-n // 128) * 128
    pad = [(0, 0), (0, n_pad - n), (0, 0), (0, 0)]

    def bhnd(x):
        return jnp.swapaxes(jnp.pad(jnp.asarray(x), pad), 1, 2)

    adj_p = jnp.pad(jnp.asarray(adj), [(0, 0), (0, n_pad - n), (0, n_pad - n)])
    o_ref, l_ref = _flash_fwd(bhnd(q), bhnd(k), bhnd(v), adj_p, 128, True)
    o_ref = np.swapaxes(np.asarray(o_ref), 1, 2)[:, :n]
    l_ref = np.asarray(l_ref)[:, :, :n, 0]
    o, lse = _fwd_tc_f32_emulation(*(torch.as_tensor(x) for x in (q, k, v, adj)))
    np.testing.assert_allclose(o_ref, o.numpy(), atol=TOL)
    np.testing.assert_allclose(l_ref, lse.numpy(), atol=TOL, rtol=1e-6)
    empty = ~adj.any(-1)
    assert empty.sum() >= 3 and np.all(o.numpy()[empty] == 0.0)
    assert np.all(lse.numpy().transpose(0, 2, 1)[empty] == np.float32(-1e9) + np.float32(np.log(1e-30)))

