"""The small-graph forward (``csrc/masked_attention_fwd_small.cu``, the
forward's ``"small_graph"`` route): its plain version against the JAX
package's ``_flash_fwd`` (the Pallas ``_attn_kernel`` in interpret mode),
the exact values of rows with no edges, the route that sends a forward of at
most 32 nodes off the tensor cores to it, its C entry point's signature, and
``MaskedAttention`` on CPU tensors. The CUDA kernel is held against the
plain version on the card in ``test_torch_cuda.py``.

The inputs are made with numpy and fed to both packages, at the 3D family's
graph sizes and head widths (N = 8 and 20; Dh 24, 136, 264 and 271), with
the 3D-like mask of ``test_torch_attention_small_graph.py``: the padding
parts last, and in the second graph dropped edges, one empty query row and
one unattended key among the valid parts.

Tolerance, float32: 2e-5 of max(1, max|reference|) for O and for L on rows
with an edge (sums taken in another order); rows with no edges exactly.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.ops.pallas_attention import _flash_fwd
from diffassemble_tpu_torch.ops import cuda_attention as ca
from test_torch_attention_small_graph import _inputs  # the 3D-like inputs (tests/ is on the path)

REL = 2e-5
# L of a query row with no edges, in f32: the row max over masked entries alone plus log(1e-30)
EMPTY_ROW_L = float(torch.tensor(-1e9) + torch.log(torch.tensor(1e-30)))


def _jax_fwd(q, k, v, adj, n):
    """O (B, N, H, Dh) and L (B, H, N) of the Pallas forward, one block of
    all N rows, interpret mode."""
    jq, jk, jv = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v))
    o, lse = _flash_fwd(jq, jk, jv, jnp.asarray(adj), n, True)
    return np.swapaxes(np.asarray(o), 1, 2), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("n, dh", [(8, 24), (8, 136), (8, 264), (8, 271), (20, 24), (20, 136), (20, 264),
                                   (20, 271)])
def test_fwd_plain_matches_pallas_flash_fwd(n, dh):
    """The forward's plain version against the Pallas forward: O everywhere
    and L on the rows with an edge within the tolerance; the CPU call counts
    no launch."""
    q, k, v, _, adj = _inputs(n, dh, seed=n * 1000 + dh + 1)
    o_ref, lse_ref = _jax_fwd(q, k, v, adj, n)
    before = [(kern.launches, dict(kern.launches_by_route)) for kern in ca.KERNELS]
    o, lse = ca.masked_attention_fwd(*(torch.as_tensor(x) for x in (q, k, v, adj)))
    assert [(kern.launches, dict(kern.launches_by_route)) for kern in ca.KERNELS] == before
    assert o.shape == q.shape and lse.shape == (q.shape[0], q.shape[2], n)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.numpy(), o_ref, atol=REL * max(1.0, np.abs(o_ref).max()), rtol=0)
    edged = np.broadcast_to(adj.any(-1)[:, None, :], lse_ref.shape)  # (B, H, N) rows with an edge
    np.testing.assert_allclose(lse.numpy()[edged], lse_ref[edged],
                               atol=REL * max(1.0, np.abs(lse_ref[edged]).max()), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, dh", [(8, 264), (20, 271)])
def test_fwd_rows_with_no_edges_are_exact(n, dh, dtype):
    """Rows with no edges (the padding parts, and an empty valid part's row):
    O exactly 0 and L exactly −1e9 + log(1e−30) in f32, as the Pallas forward
    gives them; every other value finite."""
    q, k, v, _, adj = _inputs(n, dh, seed=n + dh)
    o_ref, lse_ref = _jax_fwd(q, k, v, adj, n)
    o, lse = ca.masked_attention_fwd_plain(*(torch.as_tensor(x).to(dtype) for x in (q, k, v)), torch.as_tensor(adj))
    empty = ~adj.any(-1)  # (B, N)
    assert empty[0, -1] and empty[1, 2]
    assert o.dtype == dtype and torch.isfinite(o.float()).all()
    assert bool((o[torch.as_tensor(empty)] == 0).all()) and np.all(o_ref[empty] == 0.0)
    rows = np.broadcast_to(empty[:, None, :], lse_ref.shape)
    assert np.all(lse.numpy()[rows] == EMPTY_ROW_L) and np.all(lse_ref[rows] == EMPTY_ROW_L)
    assert EMPTY_ROW_L == -1000000064.0  # −1e9 − 69.08, the nearest f32


@pytest.mark.parametrize("n", [1, 8, 20, 32, 33, 200])
def test_fwd_route_sends_small_graphs_off_the_tensor_cores_to_the_small_kernel(n):
    """N <= 32 off the tensor-core route: the small-graph forward, in both
    types and for inputs 2 bytes off a 16-byte boundary; bf16 at Dh 32/144,
    aligned, keeps the tensor cores at any N, and f32 there takes them above
    32 nodes (3xTF32); else above 32 nodes the CUDA-core forward."""
    small = n <= ca.SMALL_GRAPH_N
    for dh, dtype, tensor_cores in ((32, torch.bfloat16, True), (144, torch.bfloat16, True),
                                    (32, torch.float32, not small), (144, torch.float32, not small),
                                    (264, torch.float32, False), (24, torch.bfloat16, False),
                                    (271, torch.bfloat16, False)):
        x = torch.zeros((1, n, 2, dh), dtype=dtype)
        want = "tensor_cores" if tensor_cores else "small_graph" if small else "cuda_cores"
        assert ca.route("masked_attention_fwd", x, x, x) == want, (n, dh, dtype)
    for dh in (32, 144):
        off = torch.zeros((1, n, 2, dh + 1), dtype=torch.bfloat16)[..., 1:]  # 2 bytes off a 16-byte boundary
        assert off.data_ptr() % 16 == 2
        assert ca.route("masked_attention_fwd", off, off, off) == ("small_graph" if small else "cuda_cores")


def test_every_c_entry_point_has_its_signature():
    """Each C function the wrappers call is defined in the source its
    library is built from, with as many parameters as ``_SIGNATURES`` gives
    ctypes; the small-graph forward takes the forward's arguments, and is
    built from its own source."""
    for name, (key, argtypes) in ca._SIGNATURES.items():
        text = ca.SOURCES[key].read_text()
        found = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert found, (name, key)
        assert len(found.group(1).split(",")) == len(argtypes), name
    assert ca._SIGNATURES["masked_attention_fwd_small"] == ("fwd_small", ca._SIGNATURES["masked_attention_fwd"][1])
    assert ca.SOURCES["fwd_small"].name == "masked_attention_fwd_small.cu"


@pytest.mark.parametrize("n, dh, dtype", [(8, 264, torch.bfloat16), (8, 32, torch.float32),
                                          (20, 271, torch.bfloat16), (20, 24, torch.float32)])
def test_function_forward_on_cpu_takes_the_plain_path_and_counts_no_launch(n, dh, dtype):
    """``MaskedAttention``'s forward on CPU tensors of a small graph is the
    plain version, bit for bit, whatever route the shapes name on the card,
    and no wrapper counts a launch."""
    q, k, v, _, adj = _inputs(n, dh, seed=2 * n + dh)
    qt, kt, vt = (torch.tensor(x).to(dtype) for x in (q, k, v))
    adj_t = torch.as_tensor(adj)
    assert ca.route("masked_attention_fwd", qt, kt, vt, adj_t) == "small_graph"
    before = [(kern.launches, dict(kern.launches_by_route)) for kern in ca.KERNELS]
    with torch.no_grad():
        out = ca.MaskedAttention.apply(qt, kt, vt, adj_t)
    assert [(kern.launches, dict(kern.launches_by_route)) for kern in ca.KERNELS] == before
    assert torch.equal(out, ca.masked_attention_fwd_plain(qt, kt, vt, adj_t)[0])
