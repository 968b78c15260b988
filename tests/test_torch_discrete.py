"""The port's discrete (D3PM) and angle 2D models against the JAX package's,
on the CPU in f32: the D3PM helpers, the losses of ``DiscreteDiffusion2D``
(cross-entropy, variational bound, hybrid; the feats-only aux CE) and of
``DiscreteDiffusion2DRot`` (with and without ``only_rotation``), both
samplers over two steps, their metrics, ``AngleDiffusion2D``'s loss (x₀
and ε) and sample, and the continuous model's ``evaluate`` and
``piece_table``. The JAX losses' random draws are replaced by numpy
draws (``jax.random.randint``, ``categorical`` as Gumbel-max over the given
Gumbel noise, ``uniform``, ``normal``); the JAX samplers' draws are replayed
from their key (a scan traces its body once). The port's functions take
every draw as an argument.

Tolerances: float results within 1e-5 relative (the same f32 operations in
another order; the losses 1e-4: softmaxes and logs of a denoiser's logits);
indices and classes exactly.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.data.batch import PuzzleBatch as JBatch
from diffassemble_tpu.models import diffusion_2d_discrete as jd
from diffassemble_tpu.models.diffusion_2d_angle import AngleDiffusion2D as JAngle
from diffassemble_tpu.models.diffusion_2d_angle import AngleDiffusion2DConfig as JAngleCfg
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.data import PuzzleBatch
from diffassemble_tpu_torch.models import diffusion_2d_discrete as td
from diffassemble_tpu_torch.models.diffusion_2d_angle import AngleDiffusion2D, AngleDiffusion2DConfig
from test_torch_3d import seeded_tree
from torch_parity import small_batch

CFG = dict(steps=20, inference_ratio=10, backbone="efficientnet_b0", architecture="exophormer", n_layers=1,
           virt_nodes=2, hidden_dim=32, heads=4, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-5):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30), np.abs(got - want).max()


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(x):
    return torch.tensor(np.asarray(x))


def _gumbel(shape, rng):
    return (-np.log(-np.log(rng.uniform(1e-12, 1.0, shape)))).astype(np.float32)


@pytest.fixture(scope="module")
def ab():
    from diffassemble_tpu.ops.schedules import DiffusionSchedule

    return np.asarray(DiffusionSchedule.create(20, "linear").alphas_cumprod)


def test_d3pm_helpers_match(ab):
    rng = _rng(1)
    k, shape = 9, (2, 5)
    x0 = rng.integers(0, k, shape)
    xt = rng.integers(0, k, shape)
    t = rng.integers(0, 20, shape)
    t[0, :2] = 0  # t = 0 takes the x0 branch
    logits = rng.standard_normal(shape + (k,)).astype(np.float32)
    g = _gumbel(shape + (k,), rng)
    abt = _t(ab)
    onehot = np.eye(k, dtype=np.float32)[x0]
    _close(td.d3pm_marginal_probs(_t(onehot), _t(t), abt, k), jd.d3pm_marginal_probs(onehot, t, ab, k))
    with mock.patch.object(jax.random, "categorical",
                           lambda key, lg, axis=-1: jnp.argmax(lg + g, axis=axis)):
        want = jd.d3pm_q_sample(jax.random.PRNGKey(0), x0, t, ab, k)
    assert np.array_equal(td.d3pm_q_sample(_t(x0), _t(t), abt, k, _t(g)).numpy(), np.asarray(want))
    for onehot_in in (False, True):
        x0l = onehot if onehot_in else logits
        _close(td.d3pm_posterior_logits(_t(xt), _t(x0l), _t(t), _t(t - 3), abt, k, x0_is_onehot=onehot_in),
               jd.d3pm_posterior_logits(xt, x0l, t, t - 3, ab, k, x0_is_onehot=onehot_in))
    other = rng.standard_normal(shape + (k,)).astype(np.float32)
    _close(td.categorical_kl_logits(_t(logits), _t(other)), jd.categorical_kl_logits(logits, other))
    _close(td.vb_term(_t(logits), _t(x0), _t(xt), _t(t), abt, k), jd.vb_term(logits, x0, xt, t, ab, k))
    _close(td.cross_entropy_smoothed(_t(logits), _t(x0), k), jd.cross_entropy_smoothed(logits, x0, k))
    with mock.patch.object(jax.random, "gumbel", lambda key, s: jnp.asarray(g)):
        want = jd.gumbel_argmax(jax.random.PRNGKey(0), logits, t)
    assert np.array_equal(td.gumbel_argmax(_t(logits), _t(t), _t(g)).numpy(), np.asarray(want))
    grid = rng.random((2, k, 2)).astype(np.float32)
    pos = grid[:, rng.permutation(k)] + 0.01 * rng.standard_normal((2, k, 2)).astype(np.float32)
    assert np.array_equal(td.indices_from_positions(_t(pos), _t(grid)).numpy(),
                          np.asarray(jd.indices_from_positions(pos, grid)))
    ang = rng.integers(0, 4, (3, 7)) * (np.pi / 2) + 0.1 * rng.standard_normal((3, 7))
    vec = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    assert np.array_equal(td.rot_class_from_vec(_t(vec)).numpy(), np.asarray(jd.rot_class_from_vec(vec)))
    u = td.gumbel((4000,), torch.Generator().manual_seed(0))
    assert abs(float(u.mean()) - 0.5772) < 0.05  # the Gumbel mean, Euler's γ


def _models(rotation: bool, seed: int, **cfg):
    """The JAX and the port's discrete model on the same seeded parameters."""
    b = small_batch()
    c = {**CFG, "rotation": rotation, "n_classes": 9, "aux_loss_weight": 0.1, **cfg}
    jcls, tcls = (jd.DiscreteDiffusion2DRot, td.DiscreteDiffusion2DRot) if rotation else \
        (jd.DiscreteDiffusion2D, td.DiscreteDiffusion2D)
    jm = jcls(jd.DiscreteDiffusion2DConfig(**c))
    jbatch = JBatch(*[jnp.asarray(a) for a in b])
    params = seeded_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jbatch), seed)
    tm = tcls(td.DiscreteDiffusion2DConfig(**c), device="cpu")
    tm.load_state_dict(convert.convert_params(jax.tree.map(np.asarray, params)), strict=True)
    return jm, tm, params, jbatch, PuzzleBatch(*[torch.as_tensor(np.asarray(a)) for a in b])


def _loss_draws(b, n, k, rotation, rng, steps=20, cf_prob=0.0):
    d = {"t_graph": rng.integers(0, steps, b), "gumbel_x": _gumbel((b, n, k), rng)}
    if rotation:
        d["gumbel_r"] = _gumbel((b, n, 4), rng)
    if cf_prob > 0:
        d["cf_keep"] = rng.random((b, 1, 1)) >= cf_prob
    return d


def _jax_loss(jm, params, jbatch, d):
    cats = [d["gumbel_x"]] + ([d["gumbel_r"]] if "gumbel_r" in d else [])
    with mock.patch.object(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(d["t_graph"][:, None])), \
            mock.patch.object(jax.random, "categorical",
                              lambda key, lg, axis=-1: jnp.argmax(lg + cats.pop(0), axis=axis)), \
            mock.patch.object(jax.random, "uniform",
                              lambda key, shape: jnp.where(jnp.asarray(d["cf_keep"]), 1.0, 0.0)):
        total, metrics = jm.loss(params, jbatch, jax.random.PRNGKey(0))
    assert not cats
    return float(total), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("loss", ["cross_entropy", "vb", "hybrid"])
def test_discrete_loss_matches(loss):
    """Positions only, with classifier-free training (its keep draw) on the vb loss."""
    cf = 0.5 if loss == "vb" else 0.0
    jm, tm, params, jbatch, batch = _models(False, 2, discrete_loss=loss, classifier_free_prob=cf)
    d = _loss_draws(2, 9, 9, False, _rng(3), cf_prob=cf)
    want_total, want = _jax_loss(jm, params, jbatch, d)
    total, got = tm.loss(batch, **{k: _t(v) for k, v in d.items()})
    assert got.keys() == want.keys()
    _close(total, want_total, 1e-4)
    for k in want:
        _close(got[k], want[k], 1e-4)


@pytest.mark.parametrize("only_rotation", [False, True])
def test_discrete_rot_loss_matches(only_rotation):
    jm, tm, params, jbatch, batch = _models(True, 4, discrete_loss="hybrid", only_rotation=only_rotation)
    d = _loss_draws(2, 9, 9, True, _rng(5))
    want_total, want = _jax_loss(jm, params, jbatch, d)
    total, got = tm.loss(batch, **{k: _t(v) for k, v in d.items()})
    assert got.keys() == want.keys() and ("x_loss" in got) is not only_rotation
    _close(total, want_total, 1e-4)
    for k in want:
        _close(got[k], want[k], 1e-4)
    total.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tm.denoiser.final_rot.parameters())


@pytest.mark.parametrize("rotation, cold", [(False, False), (True, False), (True, True)])
def test_discrete_sampler_matches(rotation, cold):
    """Two Gumbel ancestral steps (T = 20, ratio 10) on the JAX draws; with
    rotation the patches re-rotated by the accumulated classes in between."""
    jm, tm, params, jbatch, batch = _models(rotation, 6, cold_diffusion=cold, classifier_free_prob=0.5,
                                            classifier_free_w=0.3)
    # the JAX sampler's own draws, replayed from its key (the scan body is traced once)
    key = jax.random.PRNGKey(11)
    if rotation:
        k_i1, k_i2, k = jax.random.split(key, 3)
        init = [jax.random.randint(k_i1, (2, 9), 0, 9), jax.random.randint(k_i2, (2, 9), 0, 4)]
    else:
        k_init, k = jax.random.split(key)
        init = [jax.random.randint(k_init, (2, 9), 0, 9)]
    g, gr = [], []
    for _ in range(2):
        if rotation:
            k, kg1, kg2 = jax.random.split(k, 3)
            g.append(jax.random.gumbel(kg1, (2, 9, 9)))
            gr.append(jax.random.gumbel(kg2, (2, 9, 4)))
        else:
            k, kg = jax.random.split(k)
            g.append(jax.random.gumbel(kg, (2, 9, 9)))
    want = jax.jit(lambda p, b: jm.sample(p, b, key).final)(params, jbatch)
    want_m = jm.metrics_from_final(want, jbatch)
    draws = {"init_idx": _t(init[0]), "gumbel": _t(np.stack(g))}
    if rotation:
        draws.update(init_rot=_t(init[1]), gumbel_rot=_t(np.stack(gr)))
    got = tm.sample(batch, draws=draws).final
    _close(got, want, 1e-6)
    got_m = tm.metrics_from_final(got, batch)
    for k in ("piece_acc", "puzzle_correct", "n_valid"):
        _close(got_m[k], want_m[k], 1e-6)


def _angle_models(mean_type: str, angle_type: str):
    b = small_batch()
    c = {**CFG, "mean_type": mean_type, "angle_type": angle_type, "noise_weight": 0.0}
    jm = JAngle(JAngleCfg(**c))
    jbatch = JBatch(*[jnp.asarray(a) for a in b])
    params = seeded_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jbatch), 8)
    tm = AngleDiffusion2D(AngleDiffusion2DConfig(**c), device="cpu")
    tm.load_state_dict(convert.convert_params(jax.tree.map(np.asarray, params)), strict=True)
    return jm, tm, params, jbatch, PuzzleBatch(*[torch.as_tensor(np.asarray(a)) for a in b])


@pytest.mark.parametrize("mean_type, angle_type", [("xstart", "radian"), ("epsilon", "degree")])
def test_angle_model_matches(mean_type, angle_type):
    """The loss on the JAX draws, and a DDIM sample (no initial noise)."""
    jm, tm, params, jbatch, batch = _angle_models(mean_type, angle_type)
    rng = _rng(9)
    t, noise = rng.integers(0, 20, 2), rng.standard_normal((2, 9, 3)).astype(np.float32)
    with mock.patch.object(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(t[:, None])), \
            mock.patch.object(jax.random, "normal", lambda key, shape: jnp.asarray(noise)):
        want, _ = jm.loss(params, jbatch, jax.random.PRNGKey(0))
    got, aux = tm.loss(batch, t_graph=_t(t), noise=_t(noise))
    _close(got, float(want), 1e-4)
    assert set(aux) == {"loss"}
    want = jm.sample(params, jbatch, jax.random.PRNGKey(1)).final
    got = tm.sample(batch, torch.Generator().manual_seed(1)).final
    assert got.shape == (2, 9, 4)
    _close(got, want, 1e-4)
    assert dataclasses.asdict(tm.cfg)["angle_type"] == angle_type


def test_evaluate_and_piece_table_match():
    """The continuous model's ``evaluate`` (DDIM from no initial noise) and
    ``piece_table`` of its sampled poses, against the JAX package's."""
    from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JD
    from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JC
    from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig

    c = {**CFG, "rotation": True, "mean_type": "xstart"}
    b = small_batch()
    jm = JD(JC(**c))
    jbatch = JBatch(*[jnp.asarray(a) for a in b])
    params = seeded_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jbatch), 10)
    tm = Diffusion2D(Diffusion2DConfig(**c), device="cpu")
    tm.load_state_dict(convert.convert_params(jax.tree.map(np.asarray, params)), strict=True)
    batch = PuzzleBatch(*[torch.as_tensor(np.asarray(a)) for a in b])
    want = jm.evaluate(params, jbatch, jax.random.PRNGKey(1))
    got = tm.evaluate(batch, torch.Generator().manual_seed(1))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-6)
    final = np.random.default_rng(11).standard_normal((2, 9, 4)).astype(np.float32)
    want = jm.piece_table(jnp.asarray(final), jbatch)
    got = tm.piece_table(torch.tensor(final), batch)
    assert got.keys() == want.keys()
    for k in want:
        if np.asarray(want[k]).dtype == bool or np.issubdtype(np.asarray(want[k]).dtype, np.integer):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        else:
            _close(got[k], want[k], 1e-5)
