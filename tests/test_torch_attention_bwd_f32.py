"""The float32 tensor-core backward's operand rounding, emulated on the CPU.

``csrc/masked_attention_bwd_tc_f32.cu`` computes every product of the dQ and
dK/dV kernels on the tensor cores with TF32 operands (10 explicit mantissa
bits). Each f32 operand x is split into hi = tf32(x) and lo = tf32(x − hi),
rounded to nearest with ties away from zero as ``cvt.rna.tf32.f32`` rounds,
and lo·hi + hi·lo + hi·hi are summed (3xTF32). Here that splitting of the
operands is repeated in torch at the serving path's shape (B = 1, H = 8, N =
908, the 10% expander plus 8 virtual nodes, with query rows that have no
edges and keys that no query attends), the products of the halves summed by
torch's f32 ``einsum``, and held to the card's f32 gate against the plain
versions: 1e-5 relative plus 1e-5 of max|ref| (``chip_smoke.py``,
``tests/test_torch_cuda.py:_bwd_tol``). One TF32 product (hi·hi alone) must
break that gate; three must hold it. This does not model how the tensor
cores accumulate (their adds round close to toward zero, so the card's error
is larger than this one): ``chip_smoke.py --only f32_rounding`` sets the
kernels beside emulations of their accumulation on the card, and
``test_torch_cuda.py`` holds the kernels themselves to the plain versions.
"""

import numpy as np
import pytest
import torch

from diffassemble_tpu_torch.data.expander import expander_mask
from diffassemble_tpu_torch.ops import attention as tattn
from diffassemble_tpu_torch.ops import cuda_attention as ca

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


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (ties away from zero), as f32: a half
    unit of the 13 dropped bits added to the magnitude, then those bits
    cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    ulp = 2.0**-10  # one TF32 unit in [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0**-23, 1 + 1.5 * ulp, 0.0])
    want = torch.tensor([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 0.0])
    assert torch.equal(tf32(x), want)
    r = torch.randn(10_000, generator=torch.Generator().manual_seed(0))
    hi = tf32(r)
    assert bool(((hi - r).abs() <= 2.0**-11 * r.abs()).all())
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())
    lo = tf32(r - hi)
    assert bool(((hi + lo - r).abs() <= 2.0**-21 * r.abs()).all())


def _tf32_emulation(q, k, v, mask, dout, lse, delta, passes: int):
    """dQ, dK and dV with the operands rounded as
    ``masked_attention_bwd_tc_f32.cu`` rounds them: every product's two
    operands split into TF32 halves, and the products of the halves (3
    passes: lo·hi, hi·lo, hi·hi; 1 pass: hi·hi) summed by f32 ``einsum``s (not
    the tensor cores' accumulation); P and dS formed in f32 from S and dP, a
    masked entry never exponentiated."""

    def product(eq, a, b):
        a_hi, b_hi = tf32(a), tf32(b)
        if passes == 1:
            return torch.einsum(eq, a_hi, b_hi)
        a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
        return torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_hi, b_hi)

    scale = 1.0 / q.shape[-1] ** 0.5
    m = mask.bool()[:, None]
    s = product("bnhd,bmhd->bhnm", q, k) * scale
    p = torch.exp(torch.where(m, s - lse[..., None], -torch.inf))
    ds = p * (product("bnhd,bmhd->bhnm", dout, v) - delta[..., None])
    dq = product("bhnm,bmhd->bnhd", ds, k) * scale
    dk = product("bhnm,bnhd->bmhd", ds, q) * scale
    dv = product("bhnm,bnhd->bmhd", p, dout)
    return dq, dk, dv


@pytest.mark.parametrize("dh", [32, 144])
def test_3xtf32_holds_the_f32_gate_and_one_tf32_pass_breaks_it(dh):
    """At the serving path's shape with randn f32 inputs, 3xTF32 holds the
    f32 gate for dQ, dK and dV (worst error/tolerance 0.074 at Dh 32 and
    0.111 at Dh 144 here); one TF32 product breaks it for each (by 48-74x).
    A masked entry gives P = dS = 0 exactly, and 0 splits into (0, 0): empty
    query rows get dQ = 0 and unattended keys dK = dV = 0 exactly."""
    rng = np.random.default_rng(100 + dh)
    q, k, v, g = (torch.as_tensor(rng.standard_normal((1, 908, 8, dh)).astype(np.float32)) for _ in range(4))
    topo = torch.as_tensor(expander_mask(900, "10%", np.random.default_rng(0)))
    node_mask = torch.ones((1, 900), dtype=torch.bool)
    adj, _ = tattn.extend_mask_with_virtual_nodes(tattn.build_adjacency_mask(topo, node_mask), node_mask, 8)
    adj[0, EMPTY_ROWS] = False
    adj[0, :, UNATTENDED] = False
    o, lse = ca.masked_attention_fwd_plain(q, k, v, adj)
    args = (q, k, v, adj, g, lse, ca.attention_delta(g, o))
    refs = (ca.masked_attention_bwd_dq_plain(*args), *ca.masked_attention_bwd_dkv_plain(*args))

    def worst(outs):
        ratios = []
        for out, ref in zip(outs, refs):
            tol = 1e-5 * ref.abs() + 1e-5 * ref.abs().max()
            ratios.append(float(((out - ref).abs() / tol).max()))
        return ratios

    three = _tf32_emulation(*args, passes=3)
    assert max(worst(three)) <= 0.5, worst(three)
    assert min(worst(_tf32_emulation(*args, passes=1))) > 1.0
    dq, dk, dv = three
    empty, unattended = ~adj.any(-1), ~adj.any(-2)
    assert bool(empty[0, EMPTY_ROWS].all()) and bool(unattended[0, UNATTENDED].all())
    assert bool((dq[empty] == 0).all()) and bool((dk[unattended] == 0).all()) and bool((dv[unattended] == 0).all())
