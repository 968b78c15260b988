"""The fused small-graph backward (``masked_attention_bwd_small``): its plain
version against the JAX package's ``_flash_bwd`` (the two Pallas backward
kernels in interpret mode), bit for bit against the dQ and dK/dV plain
versions, the route that sends a backward of at most 32 nodes off the
tensor cores to it, and ``MaskedAttention`` on CPU tensors. The CUDA kernel
is held against the plain version on the card in ``test_torch_cuda.py``.

The inputs are made with numpy and fed to both packages, at the 3D family's
graph sizes and head widths (N = 8 and 20; Dh 24, 136 and 271, and 264 at
N = 8). The mask is built as the 3D batches build theirs, all pairs of each
object's valid parts with the padding parts last (empty query rows and keys
no query attends), plus, in the second graph, dropped edges, one empty query
row and one unattended key among the valid parts.

Tolerance, float32: 2e-5 of max(1, max|reference|), as in
``test_torch_attention_bwd.py`` (sums taken in another order, and P taken
from L where the Pallas dQ kernel recomputes the row max and denominator).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.ops.pallas_attention import _flash_bwd, _flash_fwd
from diffassemble_tpu_torch.ops import cuda_attention as ca

REL = 2e-5


def _inputs(n, dh, seed, b=2, h=2):
    """q, k, v, dO (B, N, H, Dh) f32 and a 3D-like mask (B, N, N) bool."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, n, h, dh)).astype(np.float32) for _ in range(4))
    valid = np.zeros((b, n), dtype=bool)
    valid[0, : n // 2 + 1] = True  # padding parts last
    valid[1, : n - 1] = True
    adj = valid[:, :, None] & valid[:, None, :]
    adj[1] &= rng.random((n, n)) < 0.7
    adj[1, 2] = False      # a valid part's query row with no edges
    adj[1, :, 3] = False   # a valid part no query attends
    adj[1, 0, 0] = True
    return q, k, v, g, adj


def _close(ref, out):
    ref = np.asarray(ref)
    out = out.numpy()
    assert ref.shape == out.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=REL * max(1.0, np.abs(ref).max()), rtol=0)


def _check_zeros(adj, dq, dk, dv):
    empty, unattended = ~adj.any(-1), ~adj.any(-2)  # (B, N)
    assert empty[0, -1] and empty[1, 2] and unattended[0, -1] and unattended[1, 3]
    assert np.all(dq[empty] == 0.0)
    assert np.all(dk[unattended] == 0.0) and np.all(dv[unattended] == 0.0)


@pytest.mark.parametrize("n, dh", [(8, 24), (8, 136), (8, 271), (8, 264), (20, 24), (20, 136), (20, 271)])
def test_small_plain_matches_pallas_flash_bwd(n, dh):
    """The fused plain version against the Pallas kernels (interpret mode,
    one block of all N rows), and bit for bit against the dQ and dK/dV plain
    versions on the same Δ; masked entries give exact zeros."""
    q, k, v, g, adj = _inputs(n, dh, seed=n * 1000 + dh)
    jq, jk, jv, jg = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v, g))
    jadj = jnp.asarray(adj)
    o, lse = _flash_fwd(jq, jk, jv, jadj, n, True)
    refs = [np.swapaxes(np.asarray(x), 1, 2) for x in _flash_bwd(jq, jk, jv, jadj, o, lse, jg, n, True)]

    T = torch.as_tensor
    o_t = T(np.swapaxes(np.asarray(o), 1, 2).copy())
    lse_t = T(np.asarray(lse)[..., 0].copy())
    args = (T(q), T(k), T(v), T(adj), T(g), o_t, lse_t)
    before = [kern.launches for kern in ca.KERNELS]
    dq, dk, dv = ca.masked_attention_bwd_small(*args)
    assert [kern.launches for kern in ca.KERNELS] == before  # the CPU runs the plain version, uncounted
    for ref, out in zip(refs, (dq, dk, dv)):
        _close(ref, out)
    _check_zeros(adj, dq.numpy(), dk.numpy(), dv.numpy())

    pair_args = (*args[:5], lse_t, ca.attention_delta(args[4], o_t))
    assert torch.equal(dq, ca.masked_attention_bwd_dq_plain(*pair_args))
    dk_p, dv_p = ca.masked_attention_bwd_dkv_plain(*pair_args)
    assert torch.equal(dk, dk_p) and torch.equal(dv, dv_p)


def test_small_plain_is_the_pair_bit_for_bit_in_bf16():
    """bf16 inputs: the same outputs in bf16 as the dQ and dK/dV plain
    versions, bit for bit."""
    q, k, v, g, adj = _inputs(20, 40, seed=7)
    t = [torch.as_tensor(x).bfloat16() for x in (q, k, v)]
    adj_t, g_t = torch.as_tensor(adj), torch.as_tensor(g).bfloat16()
    o, lse = ca.masked_attention_fwd_plain(*t, adj_t)
    dq, dk, dv = ca.masked_attention_bwd_small_plain(*t, adj_t, g_t, o, lse)
    pair_args = (*t, adj_t, g_t, lse, ca.attention_delta(g_t, o))
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert torch.equal(dq, ca.masked_attention_bwd_dq_plain(*pair_args))
    assert all(torch.equal(a, b) for a, b in zip((dk, dv), ca.masked_attention_bwd_dkv_plain(*pair_args)))


@pytest.mark.parametrize("n", [1, 8, 20, 32, 33, 200])
def test_route_sends_small_graphs_off_the_tensor_cores_to_the_fused_kernel(n):
    """N <= 32 off the tensor-core route: the fused kernel, in both types and
    for inputs off a 16-byte boundary; bf16 at Dh 32/144 keeps the tensor
    cores at any N; above 32 nodes the CUDA cores, except the f32 backward
    pair at Dh 32/144, which takes the tensor cores there (3xTF32). The
    forward takes the same route as the backward (its small-graph kernel at
    N <= 32 off the tensor cores), the tensor cores in f32 at Dh 32/144 above
    32 nodes too."""
    small = n <= ca.SMALL_GRAPH_N
    for dh, dtype, tensor_cores in ((32, torch.bfloat16, True), (144, torch.bfloat16, True),
                                    (32, torch.float32, False), (264, torch.float32, False),
                                    (24, torch.bfloat16, False), (271, torch.bfloat16, False)):
        x = torch.zeros((1, n, 2, dh), dtype=dtype)
        want = "tensor_cores" if tensor_cores else "small_graph" if small else "cuda_cores"
        f32_pair = dtype == torch.float32 and dh in ca.TENSOR_CORE_HEAD_DIMS and not small
        for name in ca.BACKWARD_PAIR:
            assert ca.route(name, x, x, x) == ("tensor_cores" if f32_pair else want), (n, dh, dtype, name)
        assert ca.route("masked_attention_bwd_small", x, x, x) == "small_graph"
        assert ca.route("masked_attention_fwd", x, x, x) == ("tensor_cores" if f32_pair else want)
    off = torch.zeros((1, n, 2, 33), dtype=torch.bfloat16)[..., 1:]  # 2 bytes off a 16-byte boundary
    assert off.data_ptr() % 16 == 2
    for name in ca.BACKWARD_PAIR:
        assert ca.route(name, off, off, off) == ("small_graph" if small else "cuda_cores")


@pytest.mark.parametrize("n, dh, dtype", [(8, 264, torch.float32), (20, 32, torch.float32),
                                          (20, 271, torch.bfloat16), (20, 32, torch.bfloat16)])
def test_function_on_cpu_takes_the_plain_path_and_counts_no_launch(n, dh, dtype):
    """``MaskedAttention`` on CPU tensors of a small graph: the gradients are
    the fused plain version's, whichever route the shapes name (bf16 at Dh 32
    names the tensor cores), and no wrapper counts a launch."""
    q, k, v, g, adj = _inputs(n, dh, seed=n + dh)
    qt, kt, vt = (torch.tensor(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    adj_t, g_t = torch.as_tensor(adj), torch.as_tensor(g).to(dtype)
    before = [(kern.launches, dict(kern.launches_by_route)) for kern in ca.KERNELS]
    out = ca.MaskedAttention.apply(qt, kt, vt, adj_t)
    out.backward(g_t)
    assert [(kern.launches, dict(kern.launches_by_route)) for kern in ca.KERNELS] == before
    o, lse = ca.masked_attention_fwd_plain(qt.detach(), kt.detach(), vt.detach(), adj_t)
    assert torch.equal(out.detach(), o)
    want = ca.masked_attention_bwd_small_plain(qt.detach(), kt.detach(), vt.detach(), adj_t, g_t, o, lse)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        assert torch.equal(got, ref)
    _check_zeros(adj, *(x.float().numpy() for x in want))


def test_small_wrapper_checks_o():
    """``_check`` holds O to q's shape, type and contiguity as it holds dO."""
    q, k, v, g, adj = (torch.as_tensor(x) for x in _inputs(8, 24, seed=1))
    o, lse = ca.masked_attention_fwd_plain(q, k, v, adj)
    o = o.contiguous()  # as the forward kernel writes it
    ca._check(q, k, v, adj, g, lse, o=o)
    with pytest.raises(ValueError, match="o .* does not match q"):
        ca._check(q, k, v, adj, g, lse, o=o.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ca._check(q, k, v, adj, g, lse, o=o.transpose(0, 1).contiguous().transpose(0, 1))
