"""Masked attention backward: the port's plain versions of the dQ and dK/dV
kernels against the JAX package's ``_flash_bwd`` (its two Pallas kernels in
interpret mode), and the port's autograd against ``jax.vjp`` of
``flash_masked_attention``. The CUDA kernels are held against these plain
versions on the card in ``test_torch_cuda.py``.

The inputs are made with numpy and fed to both packages; the mask is a 10%
expander over the real nodes plus virtual nodes, with padded nodes, query rows
with no edges and keys no query attends. N = 256 is two of the Pallas
kernels' 128-row blocks; N = 200 is padded to 256 (masked rows) for JAX only.

Tolerance, float32: 2e-5 of max(1, max|reference|) — sums of up to 256
products of order-1 terms taken in another order, and P taken from L
(exp(S − L)) on the port's side where the Pallas dQ kernel recomputes the row
max and denominator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.ops.pallas_attention import _flash_bwd, _flash_fwd, flash_masked_attention
from diffassemble_tpu_torch.data.expander import expander_mask
from diffassemble_tpu_torch.ops import attention as tattn
from diffassemble_tpu_torch.ops import cuda_attention as ca

REL = 2e-5
EMPTY_ROWS = slice(1, 4)  # query rows of graph 0 with no edges
UNATTENDED = slice(5, 8)  # keys of graph 0 no query attends


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads: the suite runs several test processes on one
    machine, and more threads than cores make torch's CPU kernels spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(n, dh, seed, b=2, h=2, n_virtual=8, n_padded=9):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, n, h, dh)).astype(np.float32) for _ in range(4))
    n_real = n - n_virtual
    topo = torch.as_tensor(expander_mask(n_real, "10%", np.random.default_rng(seed)))
    node_mask = torch.ones((b, n_real), dtype=torch.bool)
    node_mask[-1, n_real - n_padded:] = False  # padded nodes: empty rows and unattended keys
    adj, _ = tattn.extend_mask_with_virtual_nodes(tattn.build_adjacency_mask(topo, node_mask), node_mask,
                                                  n_virtual)
    adj[0, EMPTY_ROWS] = False
    adj[0, :, UNATTENDED] = False
    return q, k, v, g, adj.numpy()


def _bhnd_padded(x, n_pad):
    """(B, N, H, Dh) numpy → (B, H, N_pad, Dh) jax, zero rows appended."""
    pad = [(0, 0), (0, n_pad - x.shape[1]), (0, 0), (0, 0)]
    return jnp.swapaxes(jnp.pad(jnp.asarray(x), pad), 1, 2)


def _close(ref, out):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=REL * max(1.0, np.abs(ref).max()), rtol=0)


def _check_zeros(adj, dq, dk, dv):
    empty = ~adj.any(-1)       # (B, N) query rows with no edges
    unattended = ~adj.any(-2)  # (B, N) keys no query attends
    assert empty[0, EMPTY_ROWS].all() and unattended[0, UNATTENDED].all() and empty[-1, -9 - 8:-8].all()
    assert np.all(dq[empty] == 0.0)
    assert np.all(dk[unattended] == 0.0) and np.all(dv[unattended] == 0.0)


@pytest.mark.parametrize("dh", [32, 144])
@pytest.mark.parametrize("n", [256, 200])
def test_bwd_plain_matches_pallas_flash_bwd(n, dh):
    q, k, v, g, adj = _inputs(n, dh, seed=n + dh)
    n_pad = -(-n // 128) * 128
    jq, jk, jv, jg = (_bhnd_padded(x, n_pad) for x in (q, k, v, g))
    jadj = jnp.pad(jnp.asarray(adj), [(0, 0), (0, n_pad - n), (0, n_pad - n)])
    o, lse = _flash_fwd(jq, jk, jv, jadj, 128, True)
    dq_r, dk_r, dv_r = (np.swapaxes(np.asarray(x), 1, 2)[:, :n] for x in
                        _flash_bwd(jq, jk, jv, jadj, o, lse, jg, 128, True))

    T = torch.as_tensor
    o_t = T(np.swapaxes(np.asarray(o), 1, 2)[:, :n].copy())
    lse_t = T(np.asarray(lse)[:, :, :n, 0].copy())
    delta = ca.attention_delta(T(g), o_t)
    assert delta.shape == (2, 2, n) and delta.dtype == torch.float32 and delta.is_contiguous()
    args = (T(q), T(k), T(v), T(adj), T(g), lse_t, delta)
    before = [kern.launches for kern in ca.KERNELS]
    dq = ca.masked_attention_bwd_dq(*args)
    dk, dv = ca.masked_attention_bwd_dkv(*args)
    assert [kern.launches for kern in ca.KERNELS] == before  # the CPU runs the plain versions, uncounted
    assert torch.equal(dq, ca.masked_attention_bwd_dq_plain(*args))
    for ref, out in ((dq_r, dq), (dk_r, dk), (dv_r, dv)):
        _close(ref, out)
    _check_zeros(adj, dq.numpy(), dk.numpy(), dv.numpy())


@pytest.mark.parametrize("n, dh", [(200, 32), (200, 144)])
def test_autograd_matches_jax_vjp(n, dh):
    """``MaskedAttention`` and the CPU dispatch of ``masked_attention`` (plain
    attention under autograd) against ``jax.vjp`` of the Pallas kernels."""
    q, k, v, g, adj = _inputs(n, dh, seed=3 * n + dh)
    n_pad = -(-n // 128) * 128
    jadj = jnp.pad(jnp.asarray(adj), [(0, 0), (0, n_pad - n), (0, n_pad - n)])
    out_j, vjp = jax.vjp(lambda a, b_, c: flash_masked_attention(a, b_, c, jadj, 128, True),
                         *(_bhnd_padded(x, n_pad) for x in (q, k, v)))
    refs = [np.swapaxes(np.asarray(x), 1, 2)[:, :n] for x in (out_j, *vjp(_bhnd_padded(g, n_pad)))]

    for fn in (ca.MaskedAttention.apply, tattn.masked_attention):
        qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        out = fn(qt, kt, vt, torch.as_tensor(adj))
        out.backward(torch.as_tensor(g))
        for ref, got in zip(refs, (out, qt.grad, kt.grad, vt.grad)):
            _close(ref, got)
        _check_zeros(adj, qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy())


def test_function_takes_a_noncontiguous_gradient_and_gives_the_mask_none():
    q, k, v, g, adj = _inputs(40, 32, seed=1, n_virtual=2, n_padded=3)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ca.MaskedAttention.apply(qt, kt, vt, torch.as_tensor(adj))
    g_nc = torch.as_tensor(g).transpose(0, 1).contiguous().transpose(0, 1)
    assert not g_nc.is_contiguous()
    out.backward(g_nc)
    ref = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tattn._plain_masked_attention(*ref, torch.as_tensor(adj), False).backward(torch.as_tensor(g))
    for a, b in zip((qt, kt, vt), ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-5)
    grads = ca.MaskedAttention.backward(_Ctx(qt, kt, vt, adj), torch.as_tensor(g))
    assert len(grads) == 4 and grads[3] is None


class _Ctx:
    """The saved tensors ``MaskedAttention.backward`` reads."""

    def __init__(self, q, k, v, adj):
        q, k, v, adj = (x.detach() for x in (q, k, v, torch.as_tensor(adj)))
        o, lse = ca.masked_attention_fwd_plain(q, k, v, adj)
        self.saved_tensors = (q, k, v, adj, o, lse)


def test_bwd_plain_bf16_outputs_in_the_input_type():
    """bf16 in: every sum in f32, outputs rounded once to bf16 (within one
    bf16 ulp, 2^-8 relative, of the f32 result on the same bf16 inputs)."""
    q, k, v, g, adj = _inputs(40, 32, seed=2, n_virtual=2, n_padded=3)
    tb = [torch.as_tensor(x).bfloat16() for x in (q, k, v, g)]
    adj_t = torch.as_tensor(adj)
    o, lse = ca.masked_attention_fwd_plain(*tb[:3], adj_t)
    delta = ca.attention_delta(tb[3], o)
    out_b = (ca.masked_attention_bwd_dq_plain(*tb[:3], adj_t, tb[3], lse, delta),
             *ca.masked_attention_bwd_dkv_plain(*tb[:3], adj_t, tb[3], lse, delta))
    tf = [x.float() for x in tb]
    out_f = (ca.masked_attention_bwd_dq_plain(*tf[:3], adj_t, tf[3], lse, delta),
             *ca.masked_attention_bwd_dkv_plain(*tf[:3], adj_t, tf[3], lse, delta))
    for b_, f_ in zip(out_b, out_f):
        assert b_.dtype == torch.bfloat16
        assert bool(((b_.float() - f_).abs() <= 2.0**-8 * f_.abs()).all())


@pytest.mark.parametrize(
    "change, message",
    [
        (lambda a: a[:4] + (a[4].bfloat16(),) + a[5:], "does not match q"),
        (lambda a: a[:5] + (a[5][:, :, :-1],) + a[6:], r"\(B, H, N\) float32"),
        (lambda a: a[:6] + (a[6].double(),), r"\(B, H, N\) float32"),
        (lambda a: a[:4] + (a[4].transpose(0, 1).contiguous().transpose(0, 1),) + a[5:], "contiguous"),
    ],
)
def test_bwd_wrapper_checks(change, message):
    q, k, v, g, adj = _inputs(40, 32, seed=4, n_virtual=2, n_padded=3)
    t = [torch.as_tensor(x) for x in (q, k, v, adj, g)]
    o, lse = ca.masked_attention_fwd_plain(*t[:4])
    args = (*t, lse, ca.attention_delta(t[4], o))
    with pytest.raises(ValueError, match=message):
        ca._check(*change(args))
