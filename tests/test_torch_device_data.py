"""The port's device-resident corpus and held-out protocol against the JAX
package's (``train/device_data.py``, bench.py's eval loop), on the CPU.

The corpus and every gathered batch must be bit-equal: the port is given the
JAX package's own rotation draw, and the expander's ARPACK start vector is
fixed in both packages (``torch_assets.fixed_eigsh``). The held-out metrics
of a small seeded model agree within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.data.datasets import SyntheticImages as JSyntheticImages
from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JDiffusion2D
from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JConfig
from diffassemble_tpu.train import device_data as jdd
from diffassemble_tpu.train.metrics import MeanMetrics as JMeanMetrics
from diffassemble_tpu.train.metrics import update_puzzle_metrics as jupdate
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.data.datasets import SyntheticImages
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.train import device_data as tdd
from diffassemble_tpu_torch.train.heldout import heldout_eval
from torch_assets import fixed_eigsh
from torch_parity import CFG, seeded_params

HW = (6, 6)
# the flagship's held-out image knobs (weights/diffusion2d_rot30/data.json), seed + 1000
IMAGE_KW = dict(seed=1000, cache=False, canonical=0.8, hf_detail=0.25, style="default")


def _corpus(hw=HW, n=4, degree="10%"):
    images = SyntheticImages((hw[0] * 32, hw[1] * 32), n=n, **IMAGE_KW)
    with fixed_eigsh():
        jd = jdd.build_device_data(images, hw, n, degree=degree, seed=0)
        td = tdd.build_device_data(images, hw, n, degree=degree, seed=0, device="cpu")
    return jd, td


def _bit_equal(want, got, name):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape and np.array_equal(want, got), name


@pytest.mark.parametrize("degree", ["10%", -1])
def test_build_device_data_matches(degree):
    jd, td = _corpus(degree=degree)
    assert td.n_samples == 4 and td.n_nodes == 36
    for name in jdd.DevicePuzzleData._fields:
        _bit_equal(getattr(jd, name), getattr(td, name), name)


def test_heldout_images_match():
    want, got = JSyntheticImages((192, 192), n=2, **IMAGE_KW), SyntheticImages((192, 192), n=2, **IMAGE_KW)
    for i in range(2):
        assert got[i].dtype == want[i].dtype and np.array_equal(got[i], want[i])


@pytest.mark.parametrize("rotation", [True, False])
def test_gather_batch_matches_given_the_jax_draw(rotation):
    jd, td = _corpus()
    idx = np.array([2, 0, 3], dtype=np.int32)
    key = jax.random.PRNGKey(5)
    want = jdd.gather_batch(jd, jnp.asarray(idx), key if rotation else None)
    rot_k = torch.from_numpy(np.array(jax.random.randint(key, (3, 36), 0, 4))) if rotation else None
    got = tdd.gather_batch(td, torch.from_numpy(idx).long(), rot_k)
    for name in want._fields:
        _bit_equal(getattr(want, name), getattr(got, name), name)
    if rotation:
        assert len(set(rot_k.flatten().tolist())) == 4  # every rotation occurs


def test_heldout_eval_matches_the_jax_protocol():
    """bench.py's loop (slices of eval_n, rotation key fold_in(99, lo)) on a
    small seeded model, 4 puzzles of 6×6 in slices of 2, f32."""
    jd, td = _corpus()
    cfg_kw = {**CFG, "noise_weight": 0.0}
    jm = JDiffusion2D(JConfig(**cfg_kw))
    enc = seeded_params(jm.encoder, 11, jnp.zeros((1, 32, 32, 3)))
    n = td.n_nodes
    den = seeded_params(jm.denoiser, 12, jnp.zeros((1, n, 4)), jnp.zeros((1, n), jnp.int32),
                        jnp.zeros((1, n, 1088)), jnp.ones((1, n, n), bool), jnp.ones((1, n), bool))
    params = {"encoder": enc, "denoiser": den}
    eval_fn = jax.jit(lambda p, b, k: jm.metrics_from_final(jm.sample(p, b, k).final, b))
    agg, draws = JMeanMetrics(), []
    for lo in range(0, 4, 2):
        rot_key = jax.random.fold_in(jax.random.PRNGKey(99), lo)
        eb = jdd.gather_batch(jd, jnp.arange(lo, lo + 2), rot_key)
        draws.append(np.asarray(jax.random.randint(rot_key, (2, n), 0, 4)))
        bm = eval_fn(params, eb, jax.random.fold_in(jax.random.PRNGKey(7), lo))
        jupdate(agg, bm, np.asarray(eb.patches_dim), np.asarray(eb.node_mask))
    want = agg.compute()

    tm = Diffusion2D(Diffusion2DConfig(**cfg_kw), device="cpu")
    tm.load_state_dict(convert.convert_params(jax.tree_util.tree_map(np.asarray, params)))
    got = heldout_eval(tm, td, torch.from_numpy(np.concatenate(draws)), eval_n=2)
    assert want.keys() == got.keys() and "overall__piece_acc" in got and got["overall_nImages"] == 4
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
