"""The port's CUDA kernels on the card. Every test here needs a CUDA card and
skips without one. The file imports no JAX, so it runs on a machine that has
only PyTorch; there, skip the repository's conftest (it sets JAX up):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from diffassemble_tpu_torch.data import collate_puzzles, make_puzzle
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.ops import cuda_attention
from diffassemble_tpu_torch.ops.attention import extend_mask_with_virtual_nodes


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, n, h, dh, seed, n_virtual=8, n_padded=7, empty_rows=3):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal((b, n, h, dh)).astype(np.float32)) for _ in range(3))
    n_real = n - n_virtual
    node_mask = torch.ones((b, n_real), dtype=torch.bool)
    node_mask[-1, n_real - n_padded:] = False
    topo = torch.as_tensor(rng.random((b, n_real, n_real)) < 0.1)
    adj = topo & node_mask[:, :, None] & node_mask[:, None, :]
    adj, _ = extend_mask_with_virtual_nodes(adj, node_mask, n_virtual)
    adj[0, 1:1 + empty_rows] = False
    return q, k, v, adj


# the main path's widths at two N, then widths the kernels take besides: 20
# (not a multiple of 8), 104 and 264 (the 3D checkpoints' last layers); last
# an N that is not a multiple of 4 (the tensor-core forward stages such a
# mask by bytes)
SHAPES = [(200, 32), (200, 144), (908, 32), (908, 144), (200, 20), (908, 104), (908, 264), (203, 144)]


def _small_inputs(b, n, h, dh, seed):
    """As the 3D batches make them: all pairs of each object's valid parts,
    the padding parts last (3 in the last graph); in the first graph one
    valid part's query row empty and one valid part no query attends."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal((b, n, h, dh)).astype(np.float32)) for _ in range(3))
    valid = torch.ones((b, n), dtype=torch.bool)
    valid[-1, n - 3:] = False
    adj = valid[:, :, None] & valid[:, None, :]
    adj[0, 1] = False
    adj[0, :, 2] = False
    return q, k, v, adj


# graphs of at most 32 nodes (the 3D family's N = 8 and 20, and the largest):
# off the tensor-core route their backward is the fused kernel's
SMALL_SHAPES = [(8, 264), (8, 136), (20, 271), (20, 24), (20, 32), (32, 288)]


def _misaligned(x):
    """A contiguous copy of ``x`` whose data starts 2 bytes past a 16-byte
    boundary: the tensor-core route refuses it, the CUDA-core route takes it."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["by width", "cuda_cores"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, dh", SHAPES)
def test_cuda_kernel_matches_plain(n, dh, dtype, route, card):
    """O within 1e-5 relative (f32) or one bf16 ulp plus the plain version's
    rounding of probabilities to bf16 (bf16); L within 1e-5; empty rows
    exactly 0 with the plain version's L. By width, Dh 32 and 144 take the
    tensor-core forward (bf16, and f32 on these graphs of more than 32
    nodes: 3xTF32) and everything else the CUDA-core forward; with inputs off
    a 16-byte boundary every call takes the CUDA-core forward."""
    dt = getattr(torch, dtype)
    q, k, v, adj = (x.to(card) for x in _inputs(2, n, 8, dh, seed=n + dh))
    q, k, v = (x.to(dt) for x in (q, k, v))
    if route == "cuda_cores":
        q, k, v = (_misaligned(x) for x in (q, k, v))
    tensor_cores = route == "by width" and dh in (32, 144)
    want = "tensor_cores" if tensor_cores else "cuda_cores"
    assert cuda_attention.route("masked_attention_fwd", q, k, v, adj) == want
    before = cuda_attention.masked_attention_fwd.launches
    before_route = cuda_attention.masked_attention_fwd.launches_by_route[want]
    o, lse = cuda_attention.masked_attention_fwd(q, k, v, adj)
    torch.cuda.synchronize()
    assert cuda_attention.masked_attention_fwd.launches == before + 1
    assert cuda_attention.masked_attention_fwd.launches_by_route[want] == before_route + 1
    o_p, l_p = cuda_attention.masked_attention_fwd_plain(q, k, v, adj)
    vmax = v.float().abs().max()
    if dt == torch.float32:
        tol = 1e-5 * o_p.abs() + 1e-5 * vmax
    else:
        tol = 2.0**-7 * o_p.float().abs() + 2.0**-9 * vmax
    assert bool(((o.float() - o_p.float()).abs() <= tol).all())
    empty = ~adj.any(-1)
    assert bool((o[empty] == 0).all())
    nonempty = ~empty[:, None, :].expand_as(lse)
    assert bool(((lse - l_p).abs()[nonempty] <= 1e-5 * (1 + l_p.abs()[nonempty])).all())
    assert torch.equal(lse[~nonempty], l_p[~nonempty])


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, dh", SMALL_SHAPES)
def test_cuda_small_forward_matches_plain(n, dh, dtype, aligned, card):
    """The forward on graphs of at most 32 nodes (3D-like masks: padding
    parts last, an empty query row and an unattended key): off the tensor
    cores (f32, widths other than 32/144, inputs 2 bytes off a 16-byte
    boundary) one launch of the small-graph kernel, counted on its route;
    within ``test_cuda_kernel_matches_plain``'s tolerances of the plain
    version, O exactly 0 on empty rows and their L equal to the plain
    version's."""
    dt = getattr(torch, dtype)
    q, k, v, adj = (x.to(card) for x in _small_inputs(2, n, 8, dh, seed=n + dh + 1))
    q, k, v = (x.to(dt) for x in (q, k, v))
    if not aligned:
        q, k, v = (_misaligned(x) for x in (q, k, v))
    tensor_cores = aligned and dt == torch.bfloat16 and dh in (32, 144)
    want = "tensor_cores" if tensor_cores else "small_graph"
    assert cuda_attention.route("masked_attention_fwd", q, k, v, adj) == want
    kern = cuda_attention.masked_attention_fwd
    before, before_route = kern.launches, kern.launches_by_route[want]
    o, lse = cuda_attention.masked_attention_fwd(q, k, v, adj)
    torch.cuda.synchronize()
    assert kern.launches == before + 1 and kern.launches_by_route[want] == before_route + 1
    o_p, l_p = cuda_attention.masked_attention_fwd_plain(q, k, v, adj)
    vmax = v.float().abs().max()
    if dt == torch.float32:
        tol = 1e-5 * o_p.abs() + 1e-5 * vmax
    else:
        tol = 2.0**-7 * o_p.float().abs() + 2.0**-9 * vmax
    assert o.dtype == dt and bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(lse).all())
    assert bool(((o.float() - o_p.float()).abs() <= tol).all())
    empty = ~adj.any(-1)
    assert int(empty.sum()) >= 4
    assert bool((o[empty] == 0).all())
    nonempty = ~empty[:, None, :].expand_as(lse)
    assert bool(((lse - l_p).abs()[nonempty] <= 1e-5 * (1 + l_p.abs()[nonempty])).all())
    assert torch.equal(lse[~nonempty], l_p[~nonempty])


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_function_on_a_small_graph_is_one_forward_and_one_fused_launch(heads, dtype, card):
    """``MaskedAttention`` forward and backward on a 3D-sized graph (N = 8,
    Dh 264, the easy run's wide layer) at H = 8 and at a tp = 2 rank's
    H = 4: one launch of the small-graph forward and one of the fused
    backward, nothing else; the output is the forward kernel's, the
    gradients the fused kernel's on its O and L."""
    dt = getattr(torch, dtype)
    q, k, v, adj = (x.to(card) for x in _small_inputs(8, 8, heads, 264, seed=heads))
    q, k, v = (x.to(dt).requires_grad_(True) for x in (q, k, v))
    dout = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(heads), device=card).to(dt)
    before = [dict(kern.launches_by_route) for kern in cuda_attention.KERNELS]
    out = cuda_attention.MaskedAttention.apply(q, k, v, adj)
    out.backward(dout)
    torch.cuda.synchronize()
    launched = [{r: n - b[r] for r, n in kern.launches_by_route.items()}
                for kern, b in zip(cuda_attention.KERNELS, before)]
    one = {"tensor_cores": 0, "cuda_cores": 0, "small_graph": 1}
    none = dict.fromkeys(one, 0)
    assert launched == [one, none, none, one]
    o, lse = cuda_attention.masked_attention_fwd(q.detach(), k.detach(), v.detach(), adj)
    assert torch.equal(out.detach(), o)
    want = cuda_attention.masked_attention_bwd_small(q.detach(), k.detach(), v.detach(), adj, dout, o, lse)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, ref)


def _bwd_tol(ref, dtype):
    """f32: 1e-5 relative plus 1e-5 of max|ref| (sums of ~N products in
    another order); bf16: one bf16 ulp of the output (2^-7 relative) plus
    1e-4 of max|ref| (the same f32 sums, then rounded once to bf16)."""
    rel, floor = (1e-5, 1e-5) if dtype == torch.float32 else (2.0**-7, 1e-4)
    return rel * ref.abs() + floor * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["by width", "cuda_cores"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, dh", SHAPES + SMALL_SHAPES)
def test_cuda_bwd_kernels_match_plain(n, dh, dtype, route, card):
    """dQ, dK and dV of the backward kernels against their plain versions
    on the same inputs; empty query rows give dQ exactly 0 and keys no query
    attends give dK = dV exactly 0; nothing is NaN. By width, bfloat16 at
    Dh 32 and 144 takes the tensor-core kernels, and so does float32 there
    on more than 32 nodes (3xTF32); everything else takes the CUDA-core
    kernels; with inputs off a 16-byte boundary every call takes the
    CUDA-core kernels. Off the tensor cores a graph of at most 32 nodes
    takes the fused kernel instead, one launch for all three outputs, and
    the dQ and dK/dV wrappers refuse it."""
    dt = getattr(torch, dtype)
    small = n <= cuda_attention.SMALL_GRAPH_N
    if small:
        q, k, v, adj = (x.to(card) for x in _small_inputs(2, n, 8, dh, seed=n + dh))
    else:
        q, k, v, adj = (x.to(card) for x in _inputs(2, n, 8, dh, seed=n + dh))
        adj[0, :, 10:13] = False  # keys no query attends
    q, k, v = (x.to(dt) for x in (q, k, v))
    dout = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(n), device=card).to(dt)
    if route == "cuda_cores":
        q, k, v, dout = (_misaligned(x) for x in (q, k, v, dout))
    o, lse = cuda_attention.masked_attention_fwd(q, k, v, adj)
    delta = cuda_attention.attention_delta(dout, o)
    tensor_cores = route == "by width" and dh in (32, 144) and (dt == torch.bfloat16 or not small)
    want = "tensor_cores" if tensor_cores else "small_graph" if small else "cuda_cores"
    for name in cuda_attention.BACKWARD_PAIR:
        got = cuda_attention.route(name, q, k, v, adj, dout, lse, delta)
        assert got == want, (name, got)
    before = [kern.launches for kern in cuda_attention.KERNELS]
    if want == "small_graph":
        before_route = cuda_attention.masked_attention_bwd_small.launches_by_route["small_graph"]
        dq, dk, dv = cuda_attention.masked_attention_bwd_small(q, k, v, adj, dout, o, lse)
        torch.cuda.synchronize()
        assert [kern.launches for kern in cuda_attention.KERNELS] == [b + (i == 3) for i, b in enumerate(before)]
        assert cuda_attention.masked_attention_bwd_small.launches_by_route["small_graph"] == before_route + 1
        refs = cuda_attention.masked_attention_bwd_small_plain(q, k, v, adj, dout, o, lse)
        with pytest.raises(ValueError, match="masked_attention_bwd_small"):
            cuda_attention.masked_attention_bwd_dq(q, k, v, adj, dout, lse, delta)
    else:
        dq = cuda_attention.masked_attention_bwd_dq(q, k, v, adj, dout, lse, delta)
        dk, dv = cuda_attention.masked_attention_bwd_dkv(q, k, v, adj, dout, lse, delta)
        torch.cuda.synchronize()
        assert [kern.launches for kern in cuda_attention.KERNELS] == [b + (i in (1, 2)) for i, b in enumerate(before)]
        refs = (cuda_attention.masked_attention_bwd_dq_plain(q, k, v, adj, dout, lse, delta),
                *cuda_attention.masked_attention_bwd_dkv_plain(q, k, v, adj, dout, lse, delta))
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == dt and got.shape == q.shape and bool(torch.isfinite(got).all())
        assert bool(((got.float() - ref.float()).abs() <= _bwd_tol(ref.float(), dt)).all())
    empty, unattended = ~adj.any(-1), ~adj.any(-2)
    assert int(empty.sum()) >= 3 and int(unattended.sum()) >= 3
    assert bool((dq[empty] == 0).all())
    assert bool((dk[unattended] == 0).all()) and bool((dv[unattended] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("dh", [32, 144])
@pytest.mark.parametrize("n", [44, 152, 908])
def test_cuda_f32_tensor_core_pair_matches_plain(n, dh, heads, card):
    """The float32 tensor-core dQ and dK/dV kernels (3xTF32,
    ``csrc/masked_attention_bwd_tc_f32.cu``) at the 2D paths' graph sizes
    (a 6×6 puzzle's 36 + 8 nodes, the mixed corpus's 144 + 8, the
    flagship's 900 + 8) and head counts (8, and a tp = 2 rank's 4): each
    launch counted on the tensor cores, within the f32 gate of its plain
    version, with exact zeros on empty query rows and unattended keys."""
    q, k, v, adj = (x.to(card) for x in _inputs(2, n, heads, dh, seed=7 * n + dh))
    adj[0, :, 10:13] = False  # keys no query attends
    dout = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(n), device=card)
    o, lse = cuda_attention.masked_attention_fwd(q, k, v, adj)
    args = (q, k, v, adj, dout, lse, cuda_attention.attention_delta(dout, o))
    pair = (cuda_attention.masked_attention_bwd_dq, cuda_attention.masked_attention_bwd_dkv)
    assert [cuda_attention.route(kern.__name__, *args) for kern in pair] == ["tensor_cores"] * 2
    before = [kern.launches_by_route["tensor_cores"] for kern in pair]
    before_fn = [kern.launches_by_function.get(f"{kern.__name__}_tc_f32", 0) for kern in pair]
    dq = cuda_attention.masked_attention_bwd_dq(*args)
    dk, dv = cuda_attention.masked_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert [kern.launches_by_route["tensor_cores"] for kern in pair] == [b + 1 for b in before]
    assert [kern.launches_by_function[f"{kern.__name__}_tc_f32"] for kern in pair] == [b + 1 for b in before_fn]
    refs = (cuda_attention.masked_attention_bwd_dq_plain(*args), *cuda_attention.masked_attention_bwd_dkv_plain(*args))
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        assert bool(((got - ref).abs() <= _bwd_tol(ref, torch.float32)).all())
    empty, unattended = ~adj.any(-1), ~adj.any(-2)
    assert int(empty.sum()) >= 3 and int(unattended.sum()) >= 3
    assert bool((dq[empty] == 0).all())
    assert bool((dk[unattended] == 0).all()) and bool((dv[unattended] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("dh", [32, 144])
@pytest.mark.parametrize("n", [44, 152, 908])
def test_cuda_f32_tensor_core_forward_matches_plain(n, dh, heads, card):
    """The float32 tensor-core forward (3xTF32,
    ``csrc/masked_attention_fwd_tc_f32.cu``) at the 2D paths' graph sizes
    and head counts: each launch counted on the tensor cores as
    ``masked_attention_fwd_tc_f32``; O within 1e-5 relative plus 1e-5 of
    max|v| of its plain version, L within 1e-5 of 1 + |L|, empty rows
    exactly 0 with the plain version's L bit for bit, and keys no query
    attends left out."""
    q, k, v, adj = (x.to(card) for x in _inputs(2, n, heads, dh, seed=5 * n + dh))
    adj[0, :, 10:13] = False  # keys no query attends
    kern = cuda_attention.masked_attention_fwd
    assert cuda_attention.route(kern.__name__, q, k, v, adj) == "tensor_cores"
    before = kern.launches_by_route["tensor_cores"]
    before_fn = kern.launches_by_function.get("masked_attention_fwd_tc_f32", 0)
    o, lse = kern(q, k, v, adj)
    torch.cuda.synchronize()
    assert kern.launches_by_route["tensor_cores"] == before + 1
    assert kern.launches_by_function["masked_attention_fwd_tc_f32"] == before_fn + 1
    o_p, l_p = cuda_attention.masked_attention_fwd_plain(q, k, v, adj)
    assert o.dtype == torch.float32 and bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    assert bool(((o - o_p).abs() <= 1e-5 * o_p.abs() + 1e-5 * v.abs().max()).all())
    empty = ~adj.any(-1)
    assert int(empty.sum()) >= 3 and int((~adj.any(-2)).sum()) >= 3 and bool((o[empty] == 0).all())
    nonempty = ~empty[:, None, :].expand_as(lse)
    assert bool(((lse - l_p).abs()[nonempty] <= 1e-5 * (1 + l_p.abs()[nonempty])).all())
    assert torch.equal(lse[~nonempty], l_p[~nonempty])


@pytest.mark.cuda
def test_cuda_f32_function_backward_at_908_nodes_launches_the_pair_on_the_tensor_cores(card):
    """``MaskedAttention`` in float32 on the flagship's graph size (N = 908,
    Dh 32): one forward launch, ``masked_attention_fwd_tc_f32``, and dQ and
    dK/dV, all on the tensor cores, and the gradients those kernels give on
    the forward's O and L."""
    q, k, v, adj = (x.to(card) for x in _inputs(2, 908, 8, 32, seed=11))
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    dout = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(11), device=card)
    kernels = cuda_attention.KERNELS[:3]
    before = [dict(kern.launches_by_route) for kern in kernels]
    before_fn = [dict(kern.launches_by_function) for kern in kernels]
    out = cuda_attention.MaskedAttention.apply(q, k, v, adj)
    out.backward(dout)
    torch.cuda.synchronize()
    after = [kern.launches_by_route for kern in kernels]
    moved = [{r: a[r] - b[r] for r in a if a[r] != b[r]} for a, b in zip(after, before)]
    assert moved == [{"tensor_cores": 1}, {"tensor_cores": 1}, {"tensor_cores": 1}]
    moved = [{f: n - b.get(f, 0) for f, n in kern.launches_by_function.items() if n != b.get(f, 0)}
             for kern, b in zip(kernels, before_fn)]
    assert moved == [{"masked_attention_fwd_tc_f32": 1}, {"masked_attention_bwd_dq_tc_f32": 1},
                     {"masked_attention_bwd_dkv_tc_f32": 1}]
    o, lse = cuda_attention.masked_attention_fwd(q.detach(), k.detach(), v.detach(), adj)
    args = (q.detach(), k.detach(), v.detach(), adj, dout, lse, cuda_attention.attention_delta(dout, o))
    refs = (cuda_attention.masked_attention_bwd_dq_plain(*args), *cuda_attention.masked_attention_bwd_dkv_plain(*args))
    for got, ref in zip((q.grad, k.grad, v.grad), refs):
        assert bool(((got - ref).abs() <= _bwd_tol(ref, torch.float32)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n, dh, dtype", [(8, 32, "float32"), (8, 264, "float32"), (8, 264, "bfloat16"),
                                          (20, 271, "bfloat16")])
def test_cuda_fused_kernel_matches_plain_at_a_tp_ranks_heads(n, dh, dtype, card):
    """The fused kernel at a tp = 2 rank's 4 of the 3D denoiser's 8 heads
    (the dp 2 × tp 2 3D step's shapes, and the N = 20 graphs): on the
    small-graph route, within ``_bwd_tol`` of its plain version, with exact
    zeros on empty query rows and unattended keys."""
    dt = getattr(torch, dtype)
    q, k, v, adj = (x.to(card) for x in _small_inputs(8, n, 4, dh, seed=n + dh))
    q, k, v = (x.to(dt) for x in (q, k, v))
    dout = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(n), device=card).to(dt)
    o, lse = cuda_attention.masked_attention_fwd(q, k, v, adj)
    assert cuda_attention.route(cuda_attention.BACKWARD_PAIR[0], q, k, v, adj, dout, lse) == "small_graph"
    before = cuda_attention.masked_attention_bwd_small.launches_by_route["small_graph"]
    dq, dk, dv = cuda_attention.masked_attention_bwd_small(q, k, v, adj, dout, o, lse)
    torch.cuda.synchronize()
    assert cuda_attention.masked_attention_bwd_small.launches_by_route["small_graph"] == before + 1
    for got, ref in zip((dq, dk, dv), cuda_attention.masked_attention_bwd_small_plain(q, k, v, adj, dout, o, lse)):
        assert got.dtype == dt and got.shape == q.shape and bool(torch.isfinite(got).all())
        assert bool(((got.float() - ref.float()).abs() <= _bwd_tol(ref.float(), dt)).all())
    empty, unattended = ~adj.any(-1), ~adj.any(-2)
    assert bool((dq[empty] == 0).all())
    assert bool((dk[unattended] == 0).all()) and bool((dv[unattended] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_function_backward_on_a_small_graph_is_one_fused_launch(dtype, card, monkeypatch):
    """``MaskedAttention``'s backward on a 3D-sized graph (N = 20, Dh 271)
    is one launch of the fused kernel: no dQ or dK/dV launch and no Δ
    computed outside it; the gradients are the fused kernel's on the
    forward's O and L."""
    dt = getattr(torch, dtype)
    q, k, v, adj = (x.to(card) for x in _small_inputs(2, 20, 8, 271, seed=3))
    q, k, v = (x.to(dt).requires_grad_(True) for x in (q, k, v))
    dout = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(3), device=card).to(dt)
    out = cuda_attention.MaskedAttention.apply(q, k, v, adj)

    def no_delta(*args):
        raise AssertionError("attention_delta ran outside the fused kernel")

    monkeypatch.setattr(cuda_attention, "attention_delta", no_delta)
    before = [kern.launches for kern in cuda_attention.KERNELS]
    out.backward(dout)
    torch.cuda.synchronize()
    assert [kern.launches for kern in cuda_attention.KERNELS] == [b + (i == 3) for i, b in enumerate(before)]
    o, lse = cuda_attention.masked_attention_fwd(q.detach(), k.detach(), v.detach(), adj)
    want = cuda_attention.masked_attention_bwd_small(q.detach(), k.detach(), v.detach(), adj, dout, o, lse)
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_kernels_refuse_heads_wider_than_288(card):
    q = torch.zeros((1, 16, 8, 296), device=card)
    mask = torch.ones((1, 16, 16), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="head widths 1 to 288"):
        cuda_attention.masked_attention_fwd(q, q, q, mask)


@pytest.mark.cuda
def test_cuda_train_step_gives_every_attention_projection_a_gradient(card):
    """One train step on the card goes through the three kernels (4 launches
    each at 4 layers, all on the tensor cores) and gives every query/key/value weight of every layer a
    finite, nonzero gradient (dropped gradients would leave them None)."""
    from diffassemble_tpu_torch.train.train_state import create_train_state, make_train_step

    cfg = Diffusion2DConfig(steps=300, mean_type="xstart", rotation=True, architecture="exophormer",
                            n_layers=4, virt_nodes=8, hidden_dim=256, heads=8, aux_loss_weight=0.1,
                            compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    samples = [make_puzzle(rng.random((192, 192, 3)).astype(np.float32), 6, 6, 32, rotation=True, rng=rng)
               for _ in range(2)]
    batch = collate_puzzles(samples, 36).to(card)
    model = Diffusion2D(cfg, device=card, seed=0)
    opt = model.make_optimizer()
    state = create_train_state(model, opt, torch.Generator(device=card).manual_seed(0))
    step = make_train_step(model.loss, opt)
    kernels = cuda_attention.KERNELS[:3]  # the forward, dQ and dK/dV: 36 pieces + 8 virtual nodes
    before = [kern.launches for kern in cuda_attention.KERNELS]
    before_tc = [kern.launches_by_route["tensor_cores"] for kern in kernels]
    state, aux = step(state, batch)
    torch.cuda.synchronize()
    assert [kern.launches for kern in cuda_attention.KERNELS] == [b + 4 for b in before[:3]] + before[3:]
    # bf16 at the flagship's widths: every launch on the tensor cores
    assert [kern.launches_by_route["tensor_cores"] for kern in kernels] == [b + 4 for b in before_tc]
    assert np.isfinite(float(aux["loss"])) and float(aux["grad_norm"]) > 0
    names = [f"denoiser.gnn.transformer.layers.{i}.{proj}.weight"
             for i in range(4) for proj in ("query", "key", "value")]
    for name in names:
        g = model.get_parameter(name).grad  # the step leaves its (clipped) gradients there
        assert g is not None, name
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, name


@pytest.mark.cuda
def test_cuda_sample_runs_through_the_kernel(card):
    """A small f32 model samples on the card through one launch per layer and
    step, and agrees with the same seeded model on the CPU to 1e-4."""
    # heads and widths of the flagship (the kernel's head widths 32 and 144), depth cut to 2
    cfg = Diffusion2DConfig(steps=300, inference_ratio=100, mean_type="xstart", rotation=True,
                            architecture="exophormer", n_layers=2, virt_nodes=2, hidden_dim=256,
                            heads=8, compute_dtype="float32")
    rng = np.random.default_rng(0)
    s = make_puzzle(rng.random((96, 96, 3)).astype(np.float32), 3, 3, 32, rotation=True, rng=rng)
    batch = collate_puzzles([s], 9)
    before = cuda_attention.masked_attention_fwd.launches
    final = Diffusion2D(cfg, device=card, seed=1).sample(batch.to(card)).final
    assert cuda_attention.masked_attention_fwd.launches == before + 2 * 3
    ref = Diffusion2D(cfg, device="cpu", seed=1).sample(batch.to("cpu")).final
    assert torch.isfinite(final).all()
    torch.testing.assert_close(final.cpu(), ref, rtol=0, atol=1e-4)
