"""Masked attention: the port's plain versions against the JAX package's XLA
path and its Pallas forward kernel (interpret mode). The CUDA kernel is held
against its plain version on the card in ``test_torch_cuda.py``.

Tolerance on the CPU: 2e-5 absolute on outputs and log-sum-exps of order 1,
float32 sums of up to 264 products taken in another order. The head widths
are the main path's (32, 144) and two the kernels take besides (20, not a
multiple of 8, and 104, a 3D checkpoint's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.ops import attention as jattn
from diffassemble_tpu.ops.pallas_attention import _flash_fwd
from diffassemble_tpu_torch.ops import attention as tattn
from diffassemble_tpu_torch.ops import cuda_attention

TOL = 2e-5


def _inputs(b, n, h, dh, seed, n_virtual=2, n_padded=7, empty_rows=3):
    """q, k, v (B, N, H, Dh) and a mask with padded nodes, rows with no edges
    and virtual nodes; N counts the virtual nodes."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, h, dh)).astype(np.float32) for _ in range(3))
    n_real = n - n_virtual
    topo = rng.random((b, n_real, n_real)) < 0.3
    node_mask = np.ones((b, n_real), dtype=bool)
    node_mask[-1, n_real - n_padded:] = False
    adj = topo & node_mask[:, :, None] & node_mask[:, None, :]
    adj, _ = tattn.extend_mask_with_virtual_nodes(torch.as_tensor(adj), torch.as_tensor(node_mask), n_virtual)
    adj[0, 1:1 + empty_rows] = False
    return q, k, v, adj.numpy()


CASES = [(200, 32), (200, 144), (256, 32), (256, 144), (200, 20), (256, 104)]


@pytest.mark.parametrize("n, dh", CASES)
def test_plain_matches_jax_xla(n, dh):
    q, k, v, adj = _inputs(2, n, 2, dh, seed=n + dh)
    J, T = jnp.asarray, torch.as_tensor
    ref, ref_w = jattn.masked_attention(J(q), J(k), J(v), J(adj), return_weights=True, impl="xla")
    out, w = tattn.masked_attention(T(q), T(k), T(v), T(adj), return_weights=True)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), atol=TOL)
    np.testing.assert_allclose(np.asarray(ref_w), w.numpy(), atol=TOL)
    assert np.all(out.numpy()[~adj.any(-1)] == 0.0)
    np.testing.assert_allclose(tattn.masked_attention(T(q), T(k), T(v), T(adj)).numpy(), out.numpy(), atol=0)


@pytest.mark.parametrize("n, dh", CASES)
def test_kernel_plain_matches_pallas_forward(n, dh):
    """O and L of the kernel's plain version against the Pallas kernel in
    interpret mode, which needs N padded to its 128-row block."""
    q, k, v, adj = _inputs(2, n, 2, dh, seed=2 * n + dh)
    n_pad = -(-n // 128) * 128
    pad = [(0, 0), (0, n_pad - n), (0, 0), (0, 0)]

    def bhnd(x):
        return jnp.swapaxes(jnp.pad(jnp.asarray(x), pad), 1, 2)

    adj_p = jnp.pad(jnp.asarray(adj), [(0, 0), (0, n_pad - n), (0, n_pad - n)])
    o_ref, l_ref = _flash_fwd(bhnd(q), bhnd(k), bhnd(v), adj_p, 128, True)
    o_ref = np.swapaxes(np.asarray(o_ref), 1, 2)[:, :n]
    l_ref = np.asarray(l_ref)[:, :, :n, 0]
    o, lse = cuda_attention.masked_attention_fwd(*(torch.as_tensor(x) for x in (q, k, v, adj)))
    assert o.shape == q.shape and lse.shape == (2, 2, n) and lse.dtype == torch.float32
    np.testing.assert_allclose(o_ref, o.numpy(), atol=TOL)
    np.testing.assert_allclose(l_ref, lse.numpy(), atol=TOL, rtol=1e-6)
    empty = ~adj.any(-1)
    assert empty.sum() >= 3 and np.all(o.numpy()[empty] == 0.0)
    assert np.all(lse.numpy().transpose(0, 2, 1)[empty] == np.float32(-1e9) + np.float32(np.log(1e-30)))


def test_cpu_dispatch_is_plain_and_uncounted():
    q, k, v, adj = (torch.as_tensor(x) for x in _inputs(1, 40, 2, 32, seed=1))
    before = cuda_attention.masked_attention_fwd.launches
    o, _ = cuda_attention.masked_attention_fwd(q, k, v, adj)
    o_plain, _ = cuda_attention.masked_attention_fwd_plain(q, k, v, adj)
    assert torch.equal(o, o_plain)
    np.testing.assert_allclose(tattn.masked_attention(q, k, v, adj).numpy(), o.numpy(), atol=TOL)
    assert cuda_attention.masked_attention_fwd.launches == before


def test_plain_bf16_rounds_probabilities_like_pallas():
    """In bf16 the plain version rounds the normalised probabilities to bf16 and
    sums in f32, as the Pallas kernel does: within one bf16 ulp (2^-7 relative)
    of the f32 result plus 2^-9 of max|v| for the rounded probabilities."""
    q, k, v, adj = (torch.as_tensor(x) for x in _inputs(1, 64, 2, 32, seed=3))
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    o_b, l_b = cuda_attention.masked_attention_fwd_plain(qb, kb, vb, adj)
    o_f, l_f = cuda_attention.masked_attention_fwd_plain(qb.float(), kb.float(), vb.float(), adj)
    assert o_b.dtype == torch.bfloat16 and l_b.dtype == torch.float32
    tol = 2.0**-7 * o_f.abs() + 2.0**-9 * vb.float().abs().max()
    assert bool(((o_b.float() - o_f).abs() <= tol).all())
    np.testing.assert_allclose(l_b.numpy(), l_f.numpy(), atol=1e-5)


def test_mask_helpers_match_jax():
    rng = np.random.default_rng(4)
    topo = rng.random((6, 6)) < 0.5
    node_mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], dtype=bool)
    J, T = jnp.asarray, torch.as_tensor
    adj_j = jattn.build_adjacency_mask(J(topo), J(node_mask))
    adj_t = tattn.build_adjacency_mask(T(topo), T(node_mask))
    np.testing.assert_array_equal(np.asarray(adj_j), adj_t.numpy())
    for a, b in zip(jattn.extend_mask_with_virtual_nodes(adj_j, J(node_mask), 3),
                    tattn.extend_mask_with_virtual_nodes(adj_t, T(node_mask), 3)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for loops in (True, False):
        np.testing.assert_array_equal(np.asarray(jattn.fully_connected_mask(5, loops)),
                                      tattn.fully_connected_mask(5, loops).numpy())


@pytest.mark.parametrize(
    "change, message",
    [
        (lambda q, k, v, m: tuple(torch.cat([x] * 10, -1)[..., :296].contiguous() for x in (q, k, v)) + (m,),
         "head widths"),
        (lambda q, k, v, m: (q.half(), k.half(), v.half(), m), "float32 or bfloat16"),
        (lambda q, k, v, m: (q, k, v, m[:, :-1]), "mask must be"),
        (lambda q, k, v, m: (q, k, v, m.float()), "mask must be"),
        (lambda q, k, v, m: (q, k[:, :-1], v, m), "does not match q"),
        (lambda q, k, v, m: (q.transpose(0, 1).contiguous().transpose(0, 1), k, v, m), "contiguous"),
    ],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(change, message):
    q, k, v, adj = (torch.as_tensor(x) for x in _inputs(2, 20, 2, 32, seed=5))
    with pytest.raises(ValueError, match=message):
        cuda_attention._check(*change(q, k, v, adj))
