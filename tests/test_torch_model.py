"""The port's modules and its sampling slice against the JAX package, on the CPU.

Parameters come from a numpy seed in the JAX package's tree layout (shapes
from ``jax.eval_shape`` of the flax module's ``init``) and reach the port
through ``convert.convert_params``; inputs are numpy arrays fed to both.
Everything runs in float32. Tolerances are relative to the largest output
magnitude: 1e-5 for a few float32 layers, 1e-4 for the 16-conv encoder and
the 3-step sampler, where sums run in another order and (for BatchNorm in
"batch" mode) statistics are re-derived from those sums.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.data import collate_puzzles, make_puzzle
from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JDiffusion2D
from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JConfig
from diffassemble_tpu.nn import denoiser as jden
from diffassemble_tpu.nn import efficientnet as jeff
from diffassemble_tpu.nn import gnn as jgnn
from diffassemble_tpu.utils.viz import compose_from_positions as jcompose
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.cli.serve import PuzzleSolver
from diffassemble_tpu_torch.data import PuzzleBatch
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.nn import EfficientNetB0Features, Exophormer, GraphDenoiser2D
from diffassemble_tpu_torch.utils.viz import compose_from_positions

ROOT = Path(__file__).resolve().parents[1]


def seeded_params(module, seed, *inputs):
    """Numpy parameters of the flax module's shapes: kernels at 1/√fan_in,
    scales near 1, biases and tables small but non-zero."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(module, params, prefix="m"):
    sd = convert.convert_params({prefix: params})
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()})
    return module


def close(ref, out, rel):
    ref, out = np.asarray(ref), out.detach().numpy()
    assert ref.shape == out.shape
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("bn_mode", ["batch", "affine"])
def test_efficientnet_matches(bn_mode):
    x = np.random.default_rng(0).random((5, 32, 32, 3)).astype(np.float32)
    jm = jeff.EfficientNetB0Features(bn_mode=bn_mode)
    params = seeded_params(jm, 1, jnp.asarray(x))
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, jnp.asarray(x))
    tm = load(EfficientNetB0Features(bn_mode=bn_mode), params)
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    assert out.shape == (5, 1088)
    close(ref, out, 1e-4)


def _graph(b, n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    node_mask = np.ones((b, n), dtype=bool)
    node_mask[-1, n - 2:] = False
    adj = (rng.random((b, n, n)) < 0.5) & node_mask[:, :, None] & node_mask[:, None, :]
    return x, adj, node_mask


@pytest.mark.parametrize("virt_nodes", [0, 2])
def test_exophormer_matches(virt_nodes):
    x, adj, node_mask = _graph(2, 9, 24, seed=virt_nodes)
    kw = dict(hidden_dim=16, heads=4, output_size=24, n_layers=3, virt_nodes=virt_nodes)
    jm = jgnn.Exophormer(**kw)
    args = tuple(jnp.asarray(a) for a in (x, adj, node_mask))
    params = seeded_params(jm, 2, *args)
    ref, _ = jm.apply({"params": params}, *args)
    tm = load(Exophormer(24, **kw), params)
    with torch.no_grad():
        out, _ = tm(*(torch.as_tensor(a) for a in (x, adj, node_mask)))
        (out_w, w) = tm(*(torch.as_tensor(a) for a in (x, adj, node_mask)), return_weights=True)
    close(ref, out, 1e-5)
    close(ref, out_w, 1e-5)
    assert w.shape == (2, 4, 9 + virt_nodes, 9 + virt_nodes)


@pytest.mark.parametrize("two_heads, aux_head", [(False, True), (True, False)])
def test_graph_denoiser_matches(two_heads, aux_head):
    b, n, f = 2, 9, 40
    x, adj, node_mask = _graph(b, n, 4, seed=3)
    rng = np.random.default_rng(4)
    t = rng.integers(0, 50, size=(b, n)).astype(np.int32)
    feats = rng.standard_normal((b, n, f)).astype(np.float32)
    kw = dict(steps=50, input_channels=4, output_channels=4, feature_dim=f, n_layers=2,
              architecture="exophormer", virt_nodes=2, hidden_dim=16, heads=4,
              two_heads=two_heads, aux_head=aux_head)
    jm = jden.GraphDenoiser2D(**kw)
    args = tuple(jnp.asarray(a) for a in (x, t, feats, adj, node_mask))
    params = seeded_params(jm, 5, *args)
    ref = jm.apply({"params": params}, *args, return_aux=aux_head)
    tm = load(GraphDenoiser2D(**kw), params, prefix="denoiser")
    with torch.no_grad():
        out = tm(*(torch.as_tensor(a) for a in (x, t, feats, adj, node_mask)), return_aux=aux_head)
    if aux_head:
        close(ref[0], out[0], 1e-5)
        close(ref[1], out[1], 1e-5)
    else:
        close(ref, out, 1e-5)


def test_convert_layouts():
    rng = np.random.default_rng(6)
    dense, conv, dw = rng.random((3, 5)), rng.random((3, 3, 4, 6)), rng.random((5, 5, 1, 8))
    sd = convert.convert_params({"a": {"Dense_0": {"kernel": dense}, "c": {"kernel": conv},
                                       "blocks_2_1": {"conv_dw": {"kernel": dw}}, "ln": {"scale": dense[0]}}})
    assert np.array_equal(sd["a.fc1.weight"].numpy(), dense.T.astype(np.float32))
    assert np.array_equal(sd["a.c.weight"].numpy(), conv.transpose(3, 2, 0, 1).astype(np.float32))
    assert sd["a.blocks.2.1.conv_dw.weight"].shape == (8, 1, 5, 5)
    assert sd["a.ln.weight"].dtype == torch.float32


def _slice_config(**kw):
    base = dict(steps=300, inference_ratio=100, mean_type="xstart", rotation=True,
                backbone="efficientnet_b0", architecture="exophormer", n_layers=2, virt_nodes=2,
                hidden_dim=32, heads=4, aux_loss_weight=0.1, compute_dtype="float32")
    base.update(kw)
    return base


def _jax_model_and_params(cfg_kw, batch, seed):
    jm = JDiffusion2D(JConfig(**cfg_kw))
    jb = type(batch)(*[jnp.asarray(a) for a in batch])
    enc = seeded_params(jm.encoder, seed, jnp.zeros((1, 32, 32, 3)))
    n = batch.x0.shape[1]
    den = seeded_params(jm.denoiser, seed + 1, jnp.zeros((1, n, 4)), jnp.zeros((1, n), jnp.int32),
                        jnp.zeros((1, n, 1088)), jnp.ones((1, n, n), bool), jnp.ones((1, n), bool))
    return jm, jb, {"encoder": enc, "denoiser": den}


@pytest.mark.parametrize("cf", [False, True])
def test_diffusion2d_sample_matches(cf):
    """The whole slice: encoder features once, 3 DDIM steps of the denoiser,
    greedy-assignment metrics, on 3×3 puzzles, B = 2."""
    cfg_kw = _slice_config(**({"classifier_free_prob": 0.1, "classifier_free_w": 0.5} if cf else {}))
    rng = np.random.default_rng(7)
    samples = [make_puzzle(rng.random((96, 96, 3)).astype(np.float32), 3, 3, 32, rotation=True, rng=rng)
               for _ in range(2)]
    batch = collate_puzzles(samples, 9)
    jm, jb, params = _jax_model_and_params(cfg_kw, batch, seed=8)
    ref = jax.jit(lambda p, b: jm.sample(p, b, jax.random.PRNGKey(0)).final)(params, jb)
    ref_metrics = jm.metrics_from_final(ref, jb)

    tm = Diffusion2D(Diffusion2DConfig(**cfg_kw), device="cpu")
    tm.load_state_dict(convert.convert_params(jax.tree_util.tree_map(np.asarray, params)))
    tb = PuzzleBatch(*batch).to("cpu")
    final = tm.sample(tb).final
    assert final.dtype == torch.float32 and final.shape == (2, 9, 4)
    close(ref, final, 1e-4)
    metrics = tm.metrics_from_final(final, tb)
    for key in ("piece_acc", "puzzle_correct", "n_valid"):
        np.testing.assert_allclose(np.asarray(ref_metrics[key]), metrics[key].numpy(), rtol=1e-6)
    perfect = tm.metrics_from_final(tb.x0, tb)
    assert perfect["piece_acc"].tolist() == [1.0, 1.0] and perfect["puzzle_correct"].tolist() == [1.0, 1.0]


def test_flagship_config_loads_and_entry_points_need_a_card_or_cpu():
    raw = json.loads((ROOT / "weights" / "diffusion2d_rot30" / "config.json").read_text())
    cfg = Diffusion2DConfig(**raw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JConfig(**raw))
    assert cfg.dtype == torch.bfloat16 and cfg.input_channels == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Diffusion2D(cfg)


def test_puzzle_solver_predict_array_on_cpu():
    cfg = Diffusion2DConfig(**_slice_config(inference_ratio=150))
    solver = PuzzleSolver(cfg, seed=3, device="cpu", puzzle_size=3)
    img = np.random.default_rng(9).random((96, 96, 3)).astype(np.float32)
    out = solver.predict_array(img)
    assert out.shape == (96, 96, 3) and out.dtype == np.float32 and np.isfinite(out).all()
    assert np.array_equal(out, solver.predict_array(img))  # seeded: the same request, the same answer
    sd = PuzzleSolver(cfg, seed=4, device="cpu", puzzle_size=3).model.state_dict()
    loaded = PuzzleSolver(cfg, state_dict=sd, seed=3, device="cpu", puzzle_size=3).model.state_dict()
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    with pytest.raises(ValueError):
        solver.predict_array(img[:64])


def test_compose_matches_jax():
    rng = np.random.default_rng(10)
    patches = rng.integers(0, 255, size=(6, 32, 32, 3), dtype=np.uint8)
    pos = rng.uniform(-1, 1, (6, 2)).astype(np.float32)
    rot = rng.standard_normal((6, 2)).astype(np.float32)
    for r in (None, rot):
        np.testing.assert_array_equal(jcompose(patches, pos, (2, 3), r),
                                      compose_from_positions(patches, pos, (2, 3), r))
