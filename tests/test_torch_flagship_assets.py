"""The flagship's converted checkpoint and held-out draws
(``diffassemble_tpu_torch/assets/diffusion2d_rot30_ema32000.npz``): the
exporter rebuilds it from the orbax store bit for bit, the flagship loads it
strictly, and with these trained weights the port's sampler agrees with the
JAX package's on held-out-style puzzles.

Parity tolerance: f32 on both sides, 30 DDIM steps at full width; the final
poses within 1e-3 of max|final| (sums in another order through the encoder
and four attention layers, 30 times over), the greedy-assignment metrics
exactly."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JDiffusion2D
from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JConfig
from diffassemble_tpu.train import device_data as jdd
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.data.datasets import SyntheticImages
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.train import device_data as tdd
from diffassemble_tpu_torch.utils.params import load_params
from torch_assets import ASSET, ROOT, export_flagship_assets, fixed_eigsh

CONFIG = json.loads((ROOT / "weights" / "diffusion2d_rot30" / "config.json").read_text())
EXTRAS = {"heldout_rot_k", "heldout_adj_bits", "jax_version", "jax_threefry_partitionable", "step"}


def test_export_rebuilds_the_committed_asset(tmp_path):
    rebuilt = export_flagship_assets(tmp_path / "assets.npz")
    with np.load(ASSET) as want, np.load(rebuilt) as got:
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            a, b = want[key], got[key]
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key


def test_the_flagship_loads_the_asset_strictly():
    state, extras = convert.load_jax_npz(ASSET)
    assert extras.keys() == EXTRAS and int(extras["step"]) == 32000
    model = Diffusion2D(Diffusion2DConfig(**CONFIG), device="cpu")
    model.load_state_dict(state, strict=True)
    assert sum(v.numel() for v in state.values()) == 4_238_072
    rot_k = extras["heldout_rot_k"]
    assert rot_k.shape == (64, 900) and rot_k.dtype == np.uint8 and set(np.unique(rot_k)) == {0, 1, 2, 3}
    adj = np.unpackbits(extras["heldout_adj_bits"], count=900 * 900).reshape(900, 900).astype(bool)
    assert (adj == adj.T).all() and adj.diagonal().all() and set(adj.sum(1)) == {91}  # 90-regular + self loop


def _flagship_f32():
    cfg = {**CONFIG, "compute_dtype": "float32"}
    tree = load_params(ASSET)
    params = {k: v for k, v in tree.items() if isinstance(v, dict)}
    tm = Diffusion2D(Diffusion2DConfig(**cfg), device="cpu")
    tm.load_state_dict(convert.convert_params(params), strict=True)
    return JDiffusion2D(JConfig(**cfg)), params, tm


@pytest.mark.parametrize("side, n_puzzles", [(6, 1), pytest.param(30, 2, marks=pytest.mark.slow)])
def test_trained_weights_sample_as_the_jax_package_does(side, n_puzzles):
    """Held-out-style puzzles (the flagship's image knobs, seed + 1000, a 10%
    expander from seed 0), a fixed rotation draw, 30 DDIM steps."""
    jm, params, tm = _flagship_f32()
    hw = (side, side)
    images = SyntheticImages((side * 32, side * 32), n=n_puzzles, seed=1000, cache=False, canonical=0.8,
                             hf_detail=0.25, style="default")
    with fixed_eigsh():
        jd = jdd.build_device_data(images, hw, n_puzzles, degree="10%", seed=0)
        td = tdd.build_device_data(images, hw, n_puzzles, degree="10%", seed=0, device="cpu")
    key = jax.random.fold_in(jax.random.PRNGKey(99), 0)
    jb = jdd.gather_batch(jd, jnp.arange(n_puzzles), key)
    rot_k = torch.from_numpy(np.array(jax.random.randint(key, (n_puzzles, side * side), 0, 4)))
    tb = tdd.gather_batch(td, torch.arange(n_puzzles), rot_k)
    assert np.array_equal(np.asarray(jb.patches), tb.patches.numpy())

    ref = jax.jit(lambda p, b: jm.sample(p, b, jax.random.PRNGKey(7)).final)(params, jb)
    ref_metrics = jm.metrics_from_final(ref, jb)
    final = tm.sample(tb).final
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert final.shape == ref.shape and np.abs(final.numpy() - ref).max() <= 1e-3 * scale
    metrics = tm.metrics_from_final(final, tb)
    for key in ("piece_acc", "puzzle_correct", "n_valid"):
        assert np.array_equal(np.asarray(ref_metrics[key], np.float32), metrics[key].numpy().astype(np.float32)), key
    if side == 30:  # the size it was trained on: far above chance (a piece right by luck: 1/3600)
        assert float(metrics["piece_acc"].mean()) > 0.5


def _candidates(n=900, degree="10%", seed=0, tries=5):
    """The expanders ``expander_mask`` draws in turn for ``seed``, with their
    Fiedler values."""
    from diffassemble_tpu_torch.data.expander import _fiedler_value, expander_mask

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(tries):
        adj = expander_mask(n, degree, rng, max_num_iters=1)
        s, r = np.nonzero(adj & ~np.eye(n, dtype=bool))
        with fixed_eigsh():
            out.append((adj, _fiedler_value(s, r, n)))
    return out


def test_the_seed_leaves_five_expanders_with_equal_gaps():
    """Each candidate is a circulant graph under a permutation, so all five
    have the same spectral gap and the one ``expander_mask`` keeps is set by
    rounding: the committed expander is one of them."""
    cands = _candidates()
    gaps = np.array([g for _, g in cands])
    assert np.abs(gaps - gaps[0]).max() <= 1e-9 * gaps[0] and gaps[0] < 71  # under the bound 90 − 2√89 − 0.1
    _, extras = convert.load_jax_npz(ASSET)
    committed = np.unpackbits(extras["heldout_adj_bits"], count=900 * 900).reshape(900, 900).astype(bool)
    assert [np.array_equal(adj, committed) for adj, _ in cands].count(True) == 1
    assert len({np.packbits(adj).tobytes() for adj, _ in cands}) == 5


@pytest.mark.slow
def test_each_candidate_expander_scores_as_in_the_jax_package():
    """The first two held-out puzzles (calls of 2, f32) over each of the five
    expanders of seed 0: the port's piece_acc and puzzle_acc equal the JAX
    package's. Run with ``-s`` to see them."""
    from diffassemble_tpu_torch.train.heldout import heldout_eval

    jm, params, tm = _flagship_f32()
    images = SyntheticImages((960, 960), n=2, seed=1000, cache=False, canonical=0.8, hf_detail=0.25,
                             style="default")
    jd = jdd.build_device_data(images, (30, 30), 2, degree=-1, seed=0)
    td = tdd.build_device_data(images, (30, 30), 2, degree=-1, seed=0, device="cpu")
    key = jax.random.fold_in(jax.random.PRNGKey(99), 0)
    rot_k = torch.from_numpy(np.array(jax.random.randint(key, (2, 900), 0, 4)))
    eval_fn = jax.jit(lambda p, b, k: jm.metrics_from_final(jm.sample(p, b, k).final, b))
    for i, (adj, _) in enumerate(_candidates()):
        jb = jdd.gather_batch(jd._replace(adj=jnp.asarray(adj)), jnp.arange(2), key)
        want = {k: float(np.asarray(v).mean()) for k, v in eval_fn(params, jb, jax.random.PRNGKey(7)).items()}
        got = heldout_eval(tm, td._replace(adj=torch.from_numpy(adj)), rot_k, eval_n=2)
        print(f"candidate {i}: piece_acc {got['overall__piece_acc']!r}, puzzle_acc {got['overall_acc']!r}")
        assert got["overall__piece_acc"] == pytest.approx(want["piece_acc"], abs=1e-6)
        assert got["overall_acc"] == pytest.approx(want["puzzle_correct"], abs=1e-6)
