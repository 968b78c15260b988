"""The port's training step against the JAX package's, on the CPU.

The same numpy-seeded parameters (carried across with ``convert.py``), the
same batches and the same random draws (t, noise, classifier-free mask, made
on the JAX side from its keys and handed to the port) go through both
packages: the loss and its gradient for every parameter, Adafactor against
optax, and one whole train step (non-finite zeroing, clip, Adafactor, EMA).
The trainer, datasets and CLI are in ``test_torch_trainer.py``. Everything
runs in float32.

Tolerances: the loss and its parts within 1e-5 relative; gradients within
2e-4 of each parameter's largest gradient entry (the 16-conv encoder with
"batch"-mode BatchNorm re-derives statistics over 18 patches, and sums run
in another order) plus 1e-6 of the model's largest entry (gradients that are
0 in exact arithmetic and rounding noise in both packages); Adafactor updates on identical gradients within 1e-5 of
the largest update (float32 means in another order); parameters and EMA
after one whole train step within 2e-4 of each parameter's largest update
plus 1e-6 relative, except where an unfactored parameter's gradient is
within the gradient tolerance of 0 (``torch_parity.assert_same_step``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JDiffusion2D
from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JConfig
from diffassemble_tpu.train import train_state as jts
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.data import PuzzleBatch
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.train import adafactor, train_state
from torch_parity import CFG, assert_same_step, jax_draws, seeded_params, small_batch, torch_draws


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads: the suite runs several test processes on one
    machine, and more threads than cores make torch's CPU kernels spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_model(cfg_kw, params):
    model = Diffusion2D(Diffusion2DConfig(**cfg_kw), device="cpu")
    model.load_state_dict(convert.convert_params(jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model, its seeded parameters and a batch (shared by the file)."""
    jm = JDiffusion2D(JConfig(**CFG))
    batch = small_batch()
    n = batch.x0.shape[1]
    enc = seeded_params(jm.encoder, 8, jnp.zeros((1, 32, 32, 3)))
    den = seeded_params(jm.denoiser, 9, jnp.zeros((1, n, 4)), jnp.zeros((1, n), jnp.int32),
                        jnp.zeros((1, n, 1088)), jnp.ones((1, n, n), bool), jnp.ones((1, n), bool))
    jb = type(batch)(*[jnp.asarray(a) for a in batch])
    return jm, {"encoder": enc, "denoiser": den}, batch, jb


def _close_rel(ref, out, rel):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=rel * max(np.abs(ref).max(), 1e-30), rtol=0)


def test_loss_and_gradients_match_jax(jax_side):
    jm, params, batch, jb = jax_side
    rng = jax.random.PRNGKey(1)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb, rng)
    draws = jax_draws(rng, 2, batch.x0.shape, CFG["steps"], CFG["classifier_free_prob"])
    assert draws["cf_keep"].any() and not draws["cf_keep"].all()  # one puzzle keeps its features, one drops them

    model = _port_model(CFG, params)
    loss, aux = model.loss(PuzzleBatch(*batch).to("cpu"), **torch_draws(draws))
    loss.backward()
    assert set(aux) == set(aux_j) == {"loss", "total_loss", "t_mean", "aux_loss", "loss/pos", "loss/rot"}
    for key in aux_j:
        np.testing.assert_allclose(float(aux[key].detach()), float(aux_j[key]), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    ref = convert.convert_params(jax.tree_util.tree_map(np.asarray, grads_j))
    named = dict(model.named_parameters())
    assert ref.keys() == named.keys()
    # a gradient that is 0 in exact arithmetic (a key bias shifts every score
    # of a row alike; a BatchNorm bias feeding a "batch"-mode BatchNorm is
    # normalised away) is float32 rounding noise in both packages: the floor
    # 1e-6 of the largest gradient entry of the model covers it
    floor = 1e-6 * max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=2e-4 * float(g.abs().max()) + floor, err_msg=name)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_other_losses_and_frozen_backbone(jax_side, loss_type):
    """l1/l2 (the forward only, against JAX) and ``freeze_backbone``: the
    encoder gets no gradient, the denoiser does."""
    jm, params, batch, jb = jax_side
    cfg = {**CFG, "loss_type": loss_type, "freeze_backbone": True}
    jm2 = JDiffusion2D(JConfig(**cfg))
    rng = jax.random.PRNGKey(5)
    loss_j, _ = jax.jit(jm2.loss)(params, jb, rng)
    model = _port_model(cfg, params)
    loss, _ = model.loss(PuzzleBatch(*batch).to("cpu"),
                         **torch_draws(jax_draws(rng, 2, batch.x0.shape, cfg["steps"], cfg["classifier_free_prob"])))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    loss.backward()
    assert all(p.grad is None for p in model.encoder.parameters())
    assert all(p.grad is not None for p in model.denoiser.gnn.parameters())


def test_loss_draws_from_the_generator():
    """Without injected draws the loss draws t, noise and the cf mask from its
    generator: the same seed gives the same loss."""
    model = Diffusion2D(Diffusion2DConfig(**{**CFG, "n_layers": 1}), device="cpu", seed=1)
    batch = PuzzleBatch(*small_batch()).to("cpu")
    with torch.no_grad():
        a, aux_a = model.loss(batch, torch.Generator().manual_seed(4))
        b, _ = model.loss(batch, torch.Generator().manual_seed(4))
        c, _ = model.loss(batch, torch.Generator().manual_seed(5))
    assert float(a) == float(b) and float(a) != float(c)
    assert 0 <= float(aux_a["t_mean"]) < CFG["steps"]


class _Layers(torch.nn.Module):
    """A Dense kernel ≥128×128, a square one (argsort ties), a 3×3 conv, a
    depthwise conv and biases."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(130, 200)
        self.square = torch.nn.Linear(128, 128, bias=False)
        self.conv = torch.nn.Conv2d(128, 144, 3, bias=False)
        self.dw = torch.nn.Conv2d(200, 200, 3, groups=200, bias=False)


def _jax_tree(named):
    """The port's layout → the JAX package's (Dense (in, out), conv HWIO)."""
    out = {}
    for name, t in named.items():
        a = t.detach().numpy()
        out[name] = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return out


def test_adafactor_matches_optax_over_three_steps():
    """The HF schedule with warmup 2 (the first update is exactly 0), three
    steps of the same gradients through the port's Adafactor and through
    optax.adafactor, as the JAX make_optimizer builds them."""
    module = _Layers()
    torch.nn.init.normal_(module.dense.weight, std=1e-4)  # RMS below 1e-3: the parameter-scale floor
    params = {k: p.detach().clone() for k, p in module.named_parameters()}
    opt = adafactor.Adafactor(adafactor.hf_relative_schedule(2), adafactor.reference_layouts(module))
    state = opt.init(params)
    assert set(state["v_row"]) == {"dense.weight", "square.weight", "conv.weight"}
    assert set(state["v"]) == {"dense.bias", "dw.weight"}

    def schedule(step):
        lr = jnp.minimum(1e-2, 1.0 / jnp.sqrt(jnp.maximum(step, 1.0)))
        return lr * jnp.minimum(1.0, step / 2)

    jopt = optax.adafactor(learning_rate=schedule, multiply_by_parameter_scale=True)
    jparams = _jax_tree(params)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    rng = np.random.default_rng(0)
    for step in range(3):
        grads = {k: torch.as_tensor(rng.standard_normal(p.shape).astype(np.float32) * (step + 1))
                 for k, p in params.items()}
        updates, state = opt.update(grads, state, params)
        jupd, jstate = jupdate(_jax_tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        ref = _jax_tree(updates)
        for k in params:
            if step == 0:
                assert float(updates[k].abs().max()) == 0.0
            else:
                _close_rel(jupd[k], torch.as_tensor(ref[k]), 1e-5)
            params[k] = params[k] + updates[k]
    assert state["count"] == 3
    for k, a in _jax_tree(params).items():
        np.testing.assert_allclose(a, np.asarray(jparams[k]), rtol=0, atol=1e-6)


def test_train_step_matches_jax(jax_side):
    """One whole train step: a NaN gradient entry (zeroed, grad_nonfinite = 1),
    the global-norm clip (at 1, so it bites), Adafactor with the HF schedule
    and the warmup-debiased EMA, against the JAX train step."""
    jm, params, batch, jb = jax_side
    poison = ("denoiser", "time_emb", "embedding")

    def jloss(p, b, rng):
        loss, aux = jm.loss(p, b, rng)
        x = p[poison[0]][poison[1]][poison[2]][0, 0]
        return loss + 0.0 * jnp.sqrt(x - x), aux  # d/dx = 0·∞ = NaN at one entry

    jopt = jm.make_optimizer()
    jstate = jts.create_train_state(params, jopt, jax.random.PRNGKey(1), ema=True)
    _, sub = jax.random.split(jstate.rng)
    draws = jax_draws(sub, 2, batch.x0.shape, CFG["steps"], CFG["classifier_free_prob"])
    assert draws["cf_keep"].any() and not draws["cf_keep"].all()  # the encoder gets a gradient
    jnew, jaux = jts.make_train_step(jloss, jopt, max_grad_norm=1.0, ema_decay=0.999)(jstate, jb)

    model = _port_model(CFG, params)
    opt = model.make_optimizer()
    state = train_state.create_train_state(model, opt, torch.Generator().manual_seed(0), ema=True)

    def loss_fn(b, gen):
        loss, aux = model.loss(b, gen, **torch_draws(draws))
        x = model.denoiser.time_emb.weight[0, 0]
        return loss + 0.0 * torch.sqrt(x - x), aux

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = train_state.make_train_step(loss_fn, opt, max_grad_norm=1.0, ema_decay=0.999)
    state, aux = step(state, PuzzleBatch(*batch).to("cpu"))
    assert state.step == 1 and state.opt_state["count"] == 1
    assert float(aux["grad_nonfinite"]) == 1.0 == float(jaux["grad_nonfinite"])
    assert float(model.denoiser.time_emb.weight.grad[0, 0]) == 0.0
    for key in ("loss", "grad_norm", "grad_norm/encoder", "grad_norm/denoiser"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=2e-4, err_msg=key)
    assert abs(float(aux["grad_norm"]) - 1.0) < 1e-5  # clipped to the norm
    ref = convert.convert_params(jax.tree_util.tree_map(np.asarray, jnew.params))
    ref_ema = convert.convert_params(jax.tree_util.tree_map(np.asarray, jnew.ema_params))
    # the clipped gradients in .grad keep the raw gradients' ratios, so the
    # gradient test's bound marks where their sign is rounding noise
    gmax = max(float(p.grad.abs().max()) for p in model.parameters())
    for name, p in model.named_parameters():
        assert float((ref[name] - before[name]).abs().max()) > 0, name
        g_tol = 2e-4 * float(p.grad.abs().max()) + 1e-6 * gmax
        unfactored = name in state.opt_state["v"]
        assert_same_step(p.detach(), ref[name], before[name], p.grad, unfactored, g_tol, 2e-4, name)
        assert_same_step(state.ema_params[name], ref_ema[name], before[name], p.grad, unfactored, g_tol,
                         2e-4, name)


