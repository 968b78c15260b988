"""Schedules, Gaussian diffusion steps and greedy assignment against the JAX package.

Inputs and noise are made with numpy and handed to both packages. Tolerances:
the tables are the same float32 numbers (built in float64 and rounded), so
they must be equal; the diffusion updates are a few float32 operations in
the same order, checked to 1e-6 absolute on values of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.ops import assignment as jassign
from diffassemble_tpu.ops import gaussian as jg
from diffassemble_tpu.ops.schedules import DiffusionSchedule as JSched
from diffassemble_tpu.ops.schedules import extract as jextract
from diffassemble_tpu_torch.ops import assignment as tassign
from diffassemble_tpu_torch.ops import gaussian as tg
from diffassemble_tpu_torch.ops.schedules import DiffusionSchedule as TSched
from diffassemble_tpu_torch.ops.schedules import extract as textract

_FIELDS = [
    "betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_recip_alphas",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
]


@pytest.mark.parametrize("scheduler", ["linear", "cosine", "cosine_discrete", "quadratic", "sigmoid"])
def test_schedule_tables_identical(scheduler):
    a, b = JSched.create(300, scheduler), TSched.create(300, scheduler)
    for f in _FIELDS:
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert y.dtype == np.float32 and np.array_equal(x, y), f
    assert np.array_equal(a.timesteps(10), b.timesteps(10))
    t = np.random.default_rng(0).integers(0, 300, size=(2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jextract(a.betas, jnp.asarray(t))), textract(b.betas, torch.as_tensor(t)).numpy()
    )


def _sched_pair():
    return JSched.create(300, "linear"), TSched.create(300, "linear")


def test_single_steps_match():
    js, ts = _sched_pair()
    rng = np.random.default_rng(1)
    x, out, noise = (rng.standard_normal((2, 6, 4)).astype(np.float32) for _ in range(3))
    t = rng.integers(0, 300, size=(2, 6)).astype(np.int32)
    J, T = jnp.asarray, torch.as_tensor
    pairs = [
        (jg.q_sample(js, J(x), J(t), J(noise)), tg.q_sample(ts, T(x), T(t), T(noise))),
        (jg.predict_xstart_from_eps(js, J(x), J(t), J(out)), tg.predict_xstart_from_eps(ts, T(x), T(t), T(out))),
        (jg.predict_eps_from_xstart(js, J(x), J(t), J(out)), tg.predict_eps_from_xstart(ts, T(x), T(t), T(out))),
        (jg.ddim_variance(js, J(t), J(t - 10)), tg.ddim_variance(ts, T(t), T(t - 10))),
        (jg.ddim_step(js, J(x), J(t), J(out), 10, "xstart"), tg.ddim_step(ts, T(x), T(t), T(out), 10, "xstart")),
        (jg.ddim_step(js, J(x), J(t), J(out), 10, "epsilon", eta=0.5, noise=J(noise)),
         tg.ddim_step(ts, T(x), T(t), T(out), 10, "epsilon", eta=0.5, noise=T(noise))),
        (jg.ddpm_step(js, J(x), J(t), J(out), J(noise), False), tg.ddpm_step(ts, T(x), T(t), T(out), T(noise), False)),
        (jg.ddpm_step(js, J(x), J(t), J(out), J(noise), True), tg.ddpm_step(ts, T(x), T(t), T(out), T(noise), True)),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-6, err_msg=str(i))


def _jax_loop_noise(key, shape, steps):
    """The draws JAX's sample_loop makes: split the key, draw from the new half."""
    out = []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(nkey, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize(
    "sampling, mean_type, eta",
    [("ddim", "xstart", None), ("ddim", "epsilon", None), ("ddim", "epsilon", 1.0), ("ddpm", "epsilon", None),
     ("ddpm", "xstart", None)],
)
def test_sample_loop_trajectory_matches(sampling, mean_type, eta):
    """Whole trajectories with a stub denoiser and the same noise on both sides.
    Tolerance 1e-4 absolute: 30 steps of float32 updates whose coefficients
    reach ~1/√ᾱ ≈ 13 at the start of the chain."""
    js, ts = _sched_pair()
    rng = np.random.default_rng(2)
    init = rng.standard_normal((2, 5, 4)).astype(np.float32)
    w = rng.standard_normal((4, 4)).astype(np.float32) * 0.3

    def jstub(x, t):
        return jnp.tanh(x @ jnp.asarray(w)) + 1e-3 * t[..., None]

    def tstub(x, t):
        return torch.tanh(x @ torch.as_tensor(w)) + 1e-3 * t[..., None]

    key = jax.random.PRNGKey(5)
    jres = jg.sample_loop(js, jstub, jnp.asarray(init), key, inference_ratio=10, sampling=sampling,
                          mean_type=mean_type, eta=eta, keep_trajectory=True)
    noise = _jax_loop_noise(key, init.shape, 30)
    tres = tg.sample_loop(ts, tstub, torch.as_tensor(init), None, inference_ratio=10, sampling=sampling,
                          mean_type=mean_type, eta=eta, keep_trajectory=True, noise=torch.as_tensor(noise))
    assert tres.trajectory.shape == jres.trajectory.shape
    np.testing.assert_allclose(np.asarray(jres.trajectory), tres.trajectory.numpy(), rtol=1e-4, atol=1e-4)


def test_sample_loop_draws_from_generator():
    _, ts = _sched_pair()
    init = torch.zeros((1, 3, 2))
    runs = [tg.sample_loop(ts, lambda x, t: x, init, torch.Generator().manual_seed(s), 10, "ddpm").final
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("b, n, block", [(1, 9, 64), (3, 36, 64), (2, 30, 4)])
def test_greedy_assignment_matches(b, n, block):
    """Continuous random positions (no equal distances) give the same matching."""
    rng = np.random.default_rng(n)
    pos = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)
    anchors = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)
    valid = np.ones((b, n), dtype=bool)
    valid[-1, n - n // 4:] = False
    ref = np.asarray(jax.vmap(lambda p, a, v: jassign.greedy_assignment(p, a, v, block))(
        jnp.asarray(pos), jnp.asarray(anchors), jnp.asarray(valid)))
    out = tassign.greedy_assignment_batch(torch.as_tensor(pos), torch.as_tensor(anchors),
                                          torch.as_tensor(valid), block).numpy()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(ref, out)
    single = tassign.greedy_assignment(torch.as_tensor(pos[0]), torch.as_tensor(anchors[0]))
    np.testing.assert_array_equal(
        np.asarray(jassign.greedy_assignment(jnp.asarray(pos[0]), jnp.asarray(anchors[0]))), single.numpy())
