"""The port's CUDA kernel on the card. Every test here needs a CUDA card and
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, dh", [(200, 32), (200, 144), (908, 32), (908, 144)])
def test_cuda_kernel_matches_plain(n, dh, dtype, card):
    """O within 1e-5 relative (f32) or one bf16 ulp plus the plain version's
    rounding of probabilities to bf16 (bf16); L within 1e-5; empty rows
    exactly 0 with the plain version's L."""
    dt = getattr(torch, dtype)
    q, k, v, adj = (x.to(card) for x in _inputs(2, n, 8, dh, seed=n + dh))
    q, k, v = (x.to(dt) for x in (q, k, v))
    before = cuda_attention.masked_attention_fwd.launches
    o, lse = cuda_attention.masked_attention_fwd(q, k, v, adj)
    torch.cuda.synchronize()
    assert cuda_attention.masked_attention_fwd.launches == before + 1
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
