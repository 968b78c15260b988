"""The tensor-core forward (``csrc/masked_attention_fwd_tc.cu``): its rounding
scheme emulated on the CPU against the card's bf16 gate, and the build's
bookkeeping for the sources and the header they share.

The kernel itself runs only on the card (``test_torch_cuda.py`` and
``chip_smoke.py`` hold it against ``masked_attention_fwd_plain`` there). The
emulation follows it step for step: key tiles of the kernel's size per head
width, a running max from −1e9 over the edges only, the unnormalised
p̃ = exp(S − m) rounded once to bf16 before P·V, f32 sums rescaled per tile,
O = acc / max(l, 1e−30) rounded once to bf16, L = m + log(max(l, 1e−30)).
"""

import numpy as np
import pytest
import torch

from diffassemble_tpu_torch.data.expander import expander_mask
from diffassemble_tpu_torch.ops import attention as tattn
from diffassemble_tpu_torch.ops import cuda_attention as ca

KEY_TILE = {32: 64, 144: 32}  # key_tile(DH) in csrc/masked_attention_fwd_tc.cu
EMPTY_ROWS = slice(1, 4)  # query rows with no edges


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads: the suite runs several test processes on one
    machine, and more threads than cores make torch's CPU kernels spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fwd_tc_emulation(q, k, v, mask, key_tile):
    """O (bf16) and L (f32) as the tensor-core forward computes them."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
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
        pv = torch.einsum("bhnm,bmhd->bhnd", p.bfloat16().float(), v[:, k0:k0 + key_tile].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    denom = l.clamp_min(1e-30)
    o = (acc / denom[..., None]).transpose(1, 2).bfloat16()
    return o, m + torch.log(denom)


@pytest.mark.parametrize("dh", [32, 144])
def test_tensor_core_forward_rounding_holds_the_bf16_gate(dh):
    """At the serving path's shape (B = 1, H = 8, N = 908, the 10% expander
    plus 8 virtual nodes, three empty rows, randn bf16 inputs) the kernel's
    rounding holds the card's bf16 forward gate against the plain version
    (one bf16 ulp, 2^-7 relative, plus 2^-9 of max|v|): the worst
    error/tolerance is about 0.45 here. Empty rows give O = 0 and L bit-equal
    to the plain version's; L elsewhere within 1e-5 relative."""
    rng = np.random.default_rng(10 + dh)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 908, 8, dh)).astype(np.float32)).bfloat16()
               for _ in range(3))
    topo = torch.as_tensor(expander_mask(900, "10%", np.random.default_rng(0)))
    node_mask = torch.ones((1, 900), dtype=torch.bool)
    adj, _ = tattn.extend_mask_with_virtual_nodes(tattn.build_adjacency_mask(topo, node_mask), node_mask, 8)
    adj[0, EMPTY_ROWS] = False
    o_p, l_p = ca.masked_attention_fwd_plain(q, k, v, adj)
    o, lse = _fwd_tc_emulation(q, k, v, adj, KEY_TILE[dh])
    assert o.dtype == torch.bfloat16 and o.shape == q.shape and lse.shape == l_p.shape

    ref = o_p.float()
    tol = 2.0**-7 * ref.abs() + 2.0**-9 * v.float().abs().max()
    worst = float(((o.float() - ref).abs() / tol).max())
    assert 0.0 < worst <= 1.0, worst
    empty = ~adj.any(-1)  # (B, N)
    assert int(empty.sum()) == 3 and bool((o[empty] == 0).all())
    nonempty = ~empty[:, None, :].expand_as(lse)
    assert torch.equal(lse[~nonempty], l_p[~nonempty])
    assert bool(((lse - l_p).abs()[nonempty] <= 1e-5 * (1 + l_p.abs()[nonempty])).all())


def test_every_source_and_its_entry_points_are_bound():
    """Each source exists, every C function's library is a source, and each
    kernel with a tensor-core route has its ``_tc`` (bf16) and ``_tc_f32``
    (f32, 3xTF32) entry points in the tensor-core library of their own
    source."""
    assert all(p.is_file() for p in ca.SOURCES.values())
    assert {lib for lib, _ in ca._SIGNATURES.values()} == set(ca.SOURCES)
    for name in ca.TENSOR_CORE_KERNELS:
        for suffix in ("_tc", "_tc_f32"):
            assert name in ca._SIGNATURES and ca._SIGNATURES[name + suffix][0].endswith(suffix)
            assert ca._SIGNATURES[name + suffix][1] == ca._SIGNATURES[name][1]  # the same C signature
    assert ca._SIGNATURES["masked_attention_fwd_tc"][0] == "fwd_tc"
    assert ca._SIGNATURES["masked_attention_fwd_tc_f32"][0] == "fwd_tc_f32"


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Every tensor-core source includes the shared header, and each
    library's name hashes it with the source: an edit to the header builds
    anew instead of loading a stale library."""
    header = ca._PKG / "csrc" / "tc_common.cuh"
    assert header in ca.HEADERS
    for key in ("fwd_tc", "bwd_tc", "fwd_tc_f32", "bwd_tc_f32"):
        assert '#include "tc_common.cuh"' in ca.SOURCES[key].read_text()
    fake = tmp_path / "tc_common.cuh"
    fake.write_text("// one\n")
    monkeypatch.setattr(ca, "HEADERS", (fake,))
    first = ca._library_path("fwd_tc")
    fake.write_text("// two\n")
    second = ca._library_path("fwd_tc")
    assert first != second and first.parent == second.parent == ca.BUILD_DIR
    assert first.name.startswith("masked_attention_fwd_tc-") and first.suffix == ".so"


def test_compile_keeps_the_build_report_beside_the_library(tmp_path, monkeypatch):
    """nvcc's report (the -Xptxas -v lines ``chip_smoke.py``'s spill gate
    reads) is kept beside each library, so a library an earlier process built
    still has it in ``load_library().compiler_log``."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && out=$2; shift; done\n'
                    'echo "ptxas info    : Used 64 registers"\n: > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(ca, "_nvcc", lambda: str(nvcc))
    out = tmp_path / "masked_attention_fwd-0.so"
    ca._compile("fwd", out)
    assert out.exists()
    assert out.with_suffix(".log").read_text() == "== masked_attention_fwd.cu\nptxas info    : Used 64 registers\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["masked_attention_fwd-0.log", "masked_attention_fwd-0.so",
                                                          "nvcc"]
