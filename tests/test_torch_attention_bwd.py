"""Masked attention backward: the port's plain versions of the dQ and dK/dV
kernels against the JAX package's ``_flash_bwd`` (its two Pallas kernels in
interpret mode), and the port's autograd against ``jax.vjp`` of
``flash_masked_attention``. The CUDA kernels are held against these plain
versions on the card in ``test_torch_cuda.py``.

The inputs are made with numpy and fed to both packages; the mask is a 10%
expander over the real nodes plus virtual nodes, with padded nodes, query rows
with no edges and keys no query attends. N = 256 is two of the Pallas
kernels' 128-row blocks; N = 200 is padded to 256 (masked rows) for JAX only.
The head widths are the main path's (32, 144) and two the CUDA-core kernels
take besides (20, not a multiple of 8, and 104, a 3D checkpoint's).

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


@pytest.mark.parametrize("dh", [32, 144, 20, 104])
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


def _tc_emulation(q, k, v, mask, dout, lse, delta, split: bool):
    """dQ, dK and dV as the tensor-core kernels round them: S and dP from the
    bf16 inputs with f32 sums; P and dS in f32, entering their products as
    the bf16 pair hi = bf16(x), lo = bf16(x − hi) (``split``) or as bf16(x)
    alone; each product of a pair summed into one f32 result; the outputs
    rounded once to bf16."""
    p, ds, scale = ca._bwd_plain_parts(q, k, v, mask, dout, lse, delta)

    def parts(x):
        hi = x.bfloat16().float()
        return (hi, (x - hi).bfloat16().float()) if split else (hi,)

    dq = sum(torch.einsum("bhnm,bmhd->bnhd", x, k.float()) for x in parts(ds)) * scale
    dk = sum(torch.einsum("bhnm,bnhd->bmhd", x, q.float()) for x in parts(ds)) * scale
    dv = sum(torch.einsum("bhnm,bnhd->bmhd", x, dout.float()) for x in parts(p))
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("dh", [32, 144])
def test_tensor_core_rounding_holds_the_bf16_gate_only_with_the_hi_lo_split(dh):
    """The tensor cores take bf16 operands, and P and dS are f32. At the
    serving path's shape (B = 1, H = 8, N = 908, the 10% expander plus 8
    virtual nodes, randn bf16 inputs), the hi + lo split holds the card's
    bf16 gate against the plain versions (one bf16 ulp, 2^-7 relative, plus
    1e-4 of max|ref|: worst error/tolerance 0.81-0.95 here, the final bf16
    rounding's one-ulp flips, which the gate always admits); rounding P and
    dS once to bf16 breaks it (6.4-12.3 here)."""
    rng = np.random.default_rng(dh)
    q, k, v, g = (torch.as_tensor(rng.standard_normal((1, 908, 8, dh)).astype(np.float32)).bfloat16()
                  for _ in range(4))
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
            rf = ref.float()
            tol = 2.0**-7 * rf.abs() + 1e-4 * rf.abs().max()
            ratios.append(float(((out.float() - rf).abs() / tol).max()))
        return ratios

    split = _tc_emulation(*args, split=True)
    assert max(worst(split)) <= 1.0, worst(split)
    assert min(worst(_tc_emulation(*args, split=False))) > 1.0
    # a masked entry gives P = dS = 0 exactly, and the pair of 0 is (0, 0)
    dq, dk, dv = split
    empty, unattended = ~adj.any(-1), ~adj.any(-2)
    assert bool(empty[0, EMPTY_ROWS].all()) and bool(unattended[0, UNATTENDED].all())
    assert bool((dq[empty] == 0).all()) and bool((dk[unattended] == 0).all()) and bool((dv[unattended] == 0).all())


@pytest.mark.parametrize("dh", [1, 20, 32, 104, 144, 264, 288])
def test_check_takes_every_head_width_to_288(dh):
    """The kernels take every head width from 1 to 288 (9 slots of 32
    columns), both types, and raise above it, naming the limit."""
    q, k, v, g, adj = (torch.as_tensor(x) for x in _inputs(40, 1, seed=6, n_virtual=2, n_padded=3))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros((2, 40, 2, dh), dtype=dtype)
        lse = torch.zeros((2, 2, 40))
        ca._check(x, x, x, adj, x, lse, lse)
    wide = torch.zeros((2, 40, 2, 289))
    with pytest.raises(ValueError, match="head widths 1 to 288"):
        ca._check(wide, wide, wide, adj)
    with pytest.raises(ValueError, match="ROADMAP Queue 2, K3"):
        ca._check(*(torch.zeros((2, 40, 2, 296)),) * 3, adj)


def test_route_is_the_tensor_cores_for_bf16_at_the_main_path_widths():
    """bfloat16 at Dh 32 and 144 with 16-byte aligned inputs takes the
    tensor-core kernels, the forward and the backward pair alike; float32
    there takes them too on more than 32 nodes (3xTF32,
    ``test_route_in_float32``); other widths and misaligned inputs take the
    CUDA-core kernels (at N = 40: a backward of at most 32 nodes off the
    tensor cores is the fused kernel's,
    ``test_torch_attention_small_graph.py``)."""
    for name in ("masked_attention_fwd", "masked_attention_bwd_dq", "masked_attention_bwd_dkv"):
        for dh, dtype, want in ((32, torch.bfloat16, "tensor_cores"), (144, torch.bfloat16, "tensor_cores"),
                                (32, torch.float32, "tensor_cores"), (144, torch.float32, "tensor_cores"),
                                (20, torch.bfloat16, "cuda_cores"), (104, torch.bfloat16, "cuda_cores"),
                                (264, torch.bfloat16, "cuda_cores")):
            x = torch.zeros((1, 40, 2, dh), dtype=dtype)
            assert ca.route(name, x, x, x) == want, (dh, dtype, name)
        for dh in (32, 144):
            x = torch.zeros((1, 40, 2, dh + 1), dtype=torch.bfloat16)[..., 1:]  # 2 bytes off a 16-byte boundary
            y = torch.zeros((1, 40, 2, dh), dtype=torch.bfloat16)
            assert x.shape[-1] == dh and x.data_ptr() % 16 == 2
            assert ca.route(name, x, y, y) == "cuda_cores" and ca.route(name, y, y, x) == "cuda_cores", (name, dh)
    assert set(ca.REPLACES) == {*ca.TENSOR_CORE_KERNELS, "masked_attention_bwd_small"}


@pytest.mark.parametrize("n, dh, aligned, want_pair", [
    (908, 32, True, "tensor_cores"), (908, 144, True, "tensor_cores"), (152, 144, True, "tensor_cores"),
    (44, 32, True, "tensor_cores"), (33, 144, True, "tensor_cores"),
    (32, 32, True, "small_graph"), (8, 144, True, "small_graph"),
    (908, 104, True, "cuda_cores"), (44, 20, True, "cuda_cores"), (908, 264, True, "cuda_cores"),
    (908, 32, False, "cuda_cores"), (44, 144, False, "cuda_cores"), (20, 32, False, "small_graph"),
])
def test_route_in_float32(n, dh, aligned, want_pair):
    """float32: the forward and the backward pair take the tensor cores
    (3xTF32, ``csrc/masked_attention_fwd_tc_f32.cu`` and
    ``csrc/masked_attention_bwd_tc_f32.cu``) at Dh 32 and 144 on more than 32
    nodes with every base pointer 16-byte aligned; at most 32 nodes both take
    the small-graph route (the 3D family's launch gates); other widths and
    inputs off a 16-byte boundary (any one of them) take the CUDA-core
    kernels. Only ``tensors[3]`` is off a 16-byte boundary here: the
    forward's expectation follows from its own three pointers, and off that
    boundary it takes the CUDA cores as the pair does."""
    x = torch.zeros((1, n, 2, dh))
    tensors = [x, x, x, x]
    if not aligned:
        off = torch.empty(x.numel() + 1)[1:].view(x.shape)  # 4 bytes past a 16-byte boundary
        assert off.data_ptr() % 16 == 4
        tensors[3] = off
    small = n <= ca.SMALL_GRAPH_N
    fwd = "small_graph" if small else "tensor_cores" if dh in ca.TENSOR_CORE_HEAD_DIMS else "cuda_cores"
    assert ca.route("masked_attention_fwd", *tensors[:3]) == fwd
    assert ca.route("masked_attention_fwd", *tensors[1:]) == (fwd if aligned else
                                                               "small_graph" if small else "cuda_cores")
    for name in ca.BACKWARD_PAIR:
        assert ca.route(name, *tensors) == want_pair, name
    assert (ca.route(ca.BACKWARD_PAIR[0], *tensors) == "tensor_cores") == (
        n > ca.SMALL_GRAPH_N and dh in ca.TENSOR_CORE_HEAD_DIMS and aligned)


@pytest.mark.parametrize("name, way, dtype, want", [
    ("masked_attention_fwd", "tensor_cores", torch.bfloat16, "masked_attention_fwd_tc"),
    ("masked_attention_fwd", "cuda_cores", torch.float32, "masked_attention_fwd"),
    ("masked_attention_fwd", "tensor_cores", torch.float32, "masked_attention_fwd_tc_f32"),
    ("masked_attention_fwd", "small_graph", torch.float32, "masked_attention_fwd_small"),
    ("masked_attention_bwd_dq", "tensor_cores", torch.bfloat16, "masked_attention_bwd_dq_tc"),
    ("masked_attention_bwd_dq", "tensor_cores", torch.float32, "masked_attention_bwd_dq_tc_f32"),
    ("masked_attention_bwd_dkv", "tensor_cores", torch.float32, "masked_attention_bwd_dkv_tc_f32"),
    ("masked_attention_bwd_dkv", "cuda_cores", torch.bfloat16, "masked_attention_bwd_dkv"),
    ("masked_attention_bwd_small", "small_graph", torch.bfloat16, "masked_attention_bwd_small"),
])
def test_c_function_names_the_kernel_each_route_launches(name, way, dtype, want):
    """``c_function`` names the C entry point a wrapper launches (and counts in
    ``launches_by_function``) for its route and type; each is a signature of
    the library, built from the source the kernels line names."""
    assert ca.c_function(name, way, dtype) == want
    assert want in ca._SIGNATURES and ca._SIGNATURES[want][0] in ca.SOURCES


def test_reset_empties_the_counts_by_function():
    for kern in ca.KERNELS:
        kern.launches_by_function["x"] = 1
    ca.reset_launch_counts()
    assert all(kern.launches_by_function == {} and kern.launches == 0 for kern in ca.KERNELS)
