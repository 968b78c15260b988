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


def _bwd_tol(ref, dtype):
    """f32: 1e-5 relative plus 1e-5 of max|ref| (sums of ~N products in
    another order); bf16: one bf16 ulp of the output (2^-7 relative) plus
    1e-4 of max|ref| (the same f32 sums, then rounded once to bf16)."""
    rel, floor = (1e-5, 1e-5) if dtype == torch.float32 else (2.0**-7, 1e-4)
    return rel * ref.abs() + floor * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, dh", [(200, 32), (200, 144), (908, 32), (908, 144)])
def test_cuda_bwd_kernels_match_plain(n, dh, dtype, card):
    """dQ, dK and dV of the two backward kernels against their plain versions
    on the same inputs; empty query rows give dQ exactly 0 and keys no query
    attends give dK = dV exactly 0; nothing is NaN."""
    dt = getattr(torch, dtype)
    q, k, v, adj = (x.to(card) for x in _inputs(2, n, 8, dh, seed=n + dh))
    adj[0, :, 10:13] = False  # keys no query attends
    q, k, v = (x.to(dt) for x in (q, k, v))
    dout = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(n), device=card).to(dt)
    o, lse = cuda_attention.masked_attention_fwd(q, k, v, adj)
    delta = cuda_attention.attention_delta(dout, o)
    before = [kern.launches for kern in cuda_attention.KERNELS[1:]]
    dq = cuda_attention.masked_attention_bwd_dq(q, k, v, adj, dout, lse, delta)
    dk, dv = cuda_attention.masked_attention_bwd_dkv(q, k, v, adj, dout, lse, delta)
    torch.cuda.synchronize()
    assert [kern.launches for kern in cuda_attention.KERNELS[1:]] == [b + 1 for b in before]
    dq_p = cuda_attention.masked_attention_bwd_dq_plain(q, k, v, adj, dout, lse, delta)
    dk_p, dv_p = cuda_attention.masked_attention_bwd_dkv_plain(q, k, v, adj, dout, lse, delta)
    for got, ref in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert got.dtype == dt and got.shape == q.shape and bool(torch.isfinite(got).all())
        assert bool(((got.float() - ref.float()).abs() <= _bwd_tol(ref.float(), dt)).all())
    empty, unattended = ~adj.any(-1), ~adj.any(-2)
    assert int(empty.sum()) >= 3 and int(unattended.sum()) >= 3
    assert bool((dq[empty] == 0).all())
    assert bool((dk[unattended] == 0).all()) and bool((dv[unattended] == 0).all())


@pytest.mark.cuda
def test_cuda_train_step_gives_every_attention_projection_a_gradient(card):
    """One train step on the card goes through the three kernels (4 launches
    each at 4 layers) and gives every query/key/value weight of every layer a
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
    before = [kern.launches for kern in cuda_attention.KERNELS]
    state, aux = step(state, batch)
    torch.cuda.synchronize()
    assert [kern.launches for kern in cuda_attention.KERNELS] == [b + 4 for b in before]
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
