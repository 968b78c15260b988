"""The port's 3D training step against the JAX package's, on the CPU: the
loss dict of a small ``Diffusion3D`` on the JAX loss's own draws under each
branch of the loss (the five-term dict with the aux-pose pass, the
relative-pose losses and the ``rot_pt_l2_weight`` override; ``split``;
6-DoF without rotation noise; no translation noise with a frozen encoder),
its gradient for every parameter, Adafactor's factoring of every 3D
parameter against optax's, and one whole train step (non-finite zeroing,
clip, Adafactor, EMA) against the JAX step.

The model is small (2–3 parts of 32 points, 2 layers, hidden 32, f32) with
numpy-seeded weights, except the encoder: it is the pretrained VN-DGCNN of
``weights/vn_dgcnn_rich_rel3d_512.npz`` (the 3D recipe's ``encoder_init``).
Seeded VN weights leave the vector norms of an edge set nearly equal, and
VNNorm's standardization then amplifies f32 rounding into few-percent
differences of the features in either package alone; the trained weights do
not. Even so the two encoders' features differ by 3e-4 of their largest
entry (the JAX package's XLA CPU run differs from a float64 run by 1e-3, the
port's by 3e-4; XLA's fusions alone move them by 9e-5), enough to flip a
few leaky-ReLU kinks of the fusion MLP and move single gradient entries by
percents. So in both packages the point features take one value, the JAX
encoder's, while their gradient flows through each package's own encoder
(``_pinned_features``): everything after the encoder sees the same inputs,
and each encoder's gradient is its own backward of (nearly) the same
cotangent. The encoder's forward is held to the JAX package's in
``tests/test_torch_3d.py``.

Tolerances: the loss and its terms 2e-5 relative; gradients 5e-3 of each
encoder parameter's largest entry (its backward through six VNNorm
standardizations, 1.3e-3 from float64 in the JAX package and 3e-4 in the
port) and 2e-4 of any other's, plus 1e-6 of the model's largest entry
(gradients that are 0 in exact arithmetic, such as a key bias's, are
rounding noise in both); the clipped gradients' norms 5e-4 relative;
parameters and EMA after one step within 5e-3 of each parameter's largest
update plus 1e-6 relative, except where an unfactored parameter's gradient
is within the gradient tolerance of 0 (``torch_parity.assert_same_step``:
Adafactor's first step there is the sign of rounding noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffassemble_tpu.data.batch import FragmentBatch as JFragmentBatch
from diffassemble_tpu.models.diffusion_3d import Diffusion3D as JDiffusion3D
from diffassemble_tpu.models.diffusion_3d import Diffusion3DConfig as JConfig
from diffassemble_tpu.train import train_state as jts
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.data import breaking_bad as tbb
from diffassemble_tpu_torch.models import Diffusion3D, Diffusion3DConfig
from diffassemble_tpu_torch.train import adafactor, train_state
from diffassemble_tpu_torch.utils.params import load_params
from test_torch_3d import seeded_tree
from torch_parity import ROOT, assert_same_step

ENCODER_INIT = ROOT / "weights" / "vn_dgcnn_rich_rel3d_512.npz"
CFG = dict(steps=300, backbone="vn_dgcnn_rich", n_layers=2, hidden_dim=32, heads=2, max_num_part=3,
           rel_condition=True, rel_pose_weight=0.5, rel_k=4, aux_pose_weight=0.5, rot_pt_l2_weight=1.0,
           compute_dtype="float32")
DATA = dict(num_points=32, min_num_part=2, max_num_part=3, train_n=4, test_n=2, seed=1, canonical=0.9,
            wall_detail=0.08, wall_boost=3)
CASES = {
    "all": {},
    "split": dict(loss_type="split"),
    "6dof_no_rotation_noise": dict(use_6dof=True, diffuse_rotation=False),
    "no_translation_noise_frozen": dict(diffuse_translation=False, freeze_backbone=True, rot_pt_l2_weight=0.0),
}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    train_ds, _, _ = tbb.get_dataset_3d("synthetic", **DATA)
    nb = tbb.collate_fragments([train_ds[i] for i in range(2)], CFG["max_num_part"])
    assert not nb.node_mask.all()  # a padding part
    return nb


def _models(nb, **overrides):
    """(JAX model, its params, the port's model with them): seeded weights,
    the pretrained encoder."""
    cfg = {**CFG, **overrides}
    jm = JDiffusion3D(JConfig(**cfg))
    jb = JFragmentBatch(*[jnp.asarray(a) for a in nb])
    shapes = jax.eval_shape(lambda k: jm.init(k, jb), jax.random.PRNGKey(0))
    params = seeded_tree(shapes, 3)
    params["encoder"] = jax.tree.map(jnp.asarray, load_params(ENCODER_INIT)["encoder"])
    tm = Diffusion3D(Diffusion3DConfig(**cfg), device="cpu")
    tm.load_state_dict(_port(params), strict=True)
    return jm, params, tm, jb


def _pinned_features(jm, tm, params, jb):
    """Both packages' ``pcd_features`` with one value, the JAX encoder's
    features at ``params``, and each encoder's own gradient."""
    fixed = np.asarray(jax.jit(jm.pcd_features)(params, jb.pcds))
    j_own, t_own = jm.pcd_features, tm.pcd_features

    def j_pinned(p, pcds):
        feats = j_own(p, pcds)
        return feats + jax.lax.stop_gradient(jnp.asarray(fixed) - feats)

    def t_pinned(pcds):
        feats = t_own(pcds)
        return feats + (torch.tensor(fixed) - feats).detach()

    jm.pcd_features, tm.pcd_features = j_pinned, t_pinned


def _port(tree):
    return convert.convert_params(jax.tree.map(np.asarray, tree), convert.HEADS_3D)


def jax_draws(rng, b, p, steps):
    """The JAX loss's draws from ``rng`` (``k_t, k_tr, k_rot = split(rng, 3)``,
    then ``k_angle, k_axis = split(k_rot)`` inside ``igso3_sample``)."""
    k_t, k_tr, k_rot = jax.random.split(rng, 3)
    k_angle, k_axis = jax.random.split(k_rot)
    return {"t_graph": torch.tensor(np.asarray(jax.random.randint(k_t, (b,), 0, steps))),
            "noise_tr": torch.tensor(np.asarray(jax.random.normal(k_tr, (b, p, 3)))),
            "rot_u": torch.tensor(np.asarray(jax.random.uniform(k_angle, (b, p)))),
            "rot_axes": torch.tensor(np.asarray(jax.random.normal(k_axis, (b, p, 3))))}


def _grad_tol(name: str, ref: torch.Tensor, floor: float) -> float:
    return (5e-3 if name.startswith("encoder.") else 2e-4) * float(ref.abs().max()) + floor


@pytest.mark.parametrize("case", list(CASES))
def test_loss_dict_and_gradients_match_jax_on_its_draws(batch, case):
    jm, params, tm, jb = _models(batch, **CASES[case])
    rng = jax.random.PRNGKey(5)
    _pinned_features(jm, tm, params, jb)
    (loss_j, dict_j), grads_j = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb, rng)
    b, p = batch.x0.shape[:2]
    loss, loss_dict = tm.loss(batch.to("cpu"), **jax_draws(rng, b, p, CFG["steps"]))
    want_keys = {"trans_loss", "rot_loss", "aux_pose_loss", "rel_rot_loss", "rel_off_loss", "rel_conf_loss", "loss"}
    if case != "split":
        want_keys |= {"rot_pt_cd_loss", "transform_pt_cd_loss", "rot_pt_l2_loss"}
    assert set(loss_dict) == set(dict_j) == want_keys
    for key in dict_j:
        np.testing.assert_allclose(float(loss_dict[key].detach()), float(dict_j[key]), rtol=2e-5, err_msg=key)
    assert float(loss_dict["loss"].detach()) == float(loss.detach())

    loss.backward()
    ref = _port(grads_j)
    named = dict(tm.named_parameters())
    assert ref.keys() == named.keys()
    floor = 1e-6 * max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        got = named[name].grad
        if CASES[case].get("freeze_backbone") and name.startswith("encoder."):
            assert got is None and float(g.abs().max()) == 0.0, name
            continue
        assert got is not None and bool(torch.isfinite(got).all()), name
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=0, atol=_grad_tol(name, g, floor), err_msg=name)


def test_loss_draws_from_the_generator(batch):
    tm = Diffusion3D(Diffusion3DConfig(**{**CFG, "n_layers": 1}), device="cpu", seed=1)
    b = batch.to("cpu")
    with torch.no_grad():
        a, aux = tm.loss(b, torch.Generator().manual_seed(4))
        again, _ = tm.loss(b, torch.Generator().manual_seed(4))
        other, _ = tm.loss(b, torch.Generator().manual_seed(5))
        draws = tm.loss_draws(2, b.x0.shape, torch.Generator().manual_seed(4), torch.device("cpu"))
        given, _ = tm.loss(b, **draws)
    assert float(a) == float(again) == float(given) and float(a) != float(other)
    assert {k: tuple(v.shape) for k, v in draws.items()} == {
        "t_graph": (2,), "noise_tr": (2, 3, 3), "rot_u": (2, 3), "rot_axes": (2, 3, 3)}
    assert all(bool(torch.isfinite(v)) for v in aux.values())


def test_adafactor_factors_every_3d_parameter_as_optax_does(batch):
    """``reference_layouts`` views every parameter in the JAX package's layout
    (VN channel mixes and the heads' Dense kernels transposed, U and V and
    the VNNorm scales as they are), and Adafactor factors the same
    parameters over the same dimensions as optax does the JAX tree."""
    _, params, tm, _ = _models(batch)
    paths = [path for path, _ in jax.tree_util.tree_leaves_with_path(params)]
    # each leaf filled with its own index, then with 0, 1, 2, ... in its layout
    ids = _port(jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), [
        np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(jax.tree_util.tree_leaves(params))]))
    counting = jax.tree.map(lambda x: np.arange(x.size, dtype=np.float32).reshape(x.shape), params)
    counted = _port(counting)
    jleaves = jax.tree_util.tree_leaves(counting)
    layouts = adafactor.reference_layouts(tm)
    state = tm.make_optimizer().init(dict(tm.named_parameters()))
    jstate = optax.adafactor(learning_rate=1e-2, multiply_by_parameter_scale=True).init(params)
    jv_row = jax.tree_util.tree_leaves(jstate[0].v_row)
    assert len(jv_row) == len(jleaves) == len(ids)
    for name, _ in tm.named_parameters():
        i = int(ids[name].reshape(-1)[0])
        perm = layouts.get(name)
        in_jax_layout = counted[name].numpy().transpose(perm) if perm else counted[name].numpy()
        assert np.array_equal(in_jax_layout, jleaves[i]), (name, paths[i])
        if name in state["v_row"]:
            assert tuple(state["v_row"][name].shape) == tuple(jv_row[i].shape), name
        else:  # optax keeps a one-entry placeholder for an unfactored leaf
            assert name in state["v"] and np.asarray(jv_row[i]).size == 1, name
    assert len(state["v_row"]) > 0 and len(state["v"]) > 0


def test_train_step_matches_jax(batch):
    """One whole train step: a NaN gradient entry (zeroed, grad_nonfinite 1),
    the global-norm clip at 1 (it bites), Adafactor with the HF schedule and
    no warmup (a non-zero first update), the warmup-debiased EMA."""
    jm, params, tm, jb = _models(batch, warmup_steps=0)
    poison = ("denoiser", "time_emb", "embedding")

    def jloss(p, b, rng):
        loss, aux = jm.loss(p, b, rng)
        x = p[poison[0]][poison[1]][poison[2]][0, 0]
        return loss + 0.0 * jnp.sqrt(x - x), aux  # d/dx = 0·∞ = NaN at one entry

    _pinned_features(jm, tm, params, jb)
    jopt = jm.make_optimizer()
    jstate = jts.create_train_state(params, jopt, jax.random.PRNGKey(1), ema=True)
    _, sub = jax.random.split(jstate.rng)
    draws = jax_draws(sub, *batch.x0.shape[:2], CFG["steps"])
    jnew, jaux = jts.make_train_step(jloss, jopt, max_grad_norm=1.0, ema_decay=0.999)(jstate, jb)

    opt = tm.make_optimizer()
    state = train_state.create_train_state(tm, opt, torch.Generator().manual_seed(0), ema=True)

    def loss_fn(b, gen):
        loss, aux = tm.loss(b, gen, **draws)
        x = tm.denoiser.time_emb.weight[0, 0]
        return loss + 0.0 * torch.sqrt(x - x), aux

    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    state, aux = train_state.make_train_step(loss_fn, opt, max_grad_norm=1.0, ema_decay=0.999)(
        state, batch.to("cpu"))
    assert state.step == 1 and state.opt_state["count"] == 1
    assert float(aux["grad_nonfinite"]) == 1.0 == float(jaux["grad_nonfinite"])
    assert float(tm.denoiser.time_emb.weight.grad[0, 0]) == 0.0
    for key, jkey in (("loss", "loss"), ("grad_norm", "grad_norm"), ("grad_norm/encoder", "grad_norm/encoder"),
                      ("grad_norm/denoiser", "grad_norm/denoiser"), ("grad_norm/rel_head", "grad_norm/relpose")):
        np.testing.assert_allclose(float(aux[key]), float(jaux[jkey]), rtol=5e-4, err_msg=key)
    assert abs(float(aux["grad_norm"]) - 1.0) < 1e-5  # clipped to the norm
    ref, ref_ema = _port(jnew.params), _port(jnew.ema_params)
    gmax = max(float(p.grad.abs().max()) for p in tm.parameters())
    for name, p in tm.named_parameters():
        assert float((ref[name] - before[name]).abs().max()) > 0, name
        g_tol = _grad_tol(name, p.grad, 1e-6 * gmax)
        unfactored = name in state.opt_state["v"]
        assert_same_step(p.detach(), ref[name], before[name], p.grad, unfactored, g_tol, 5e-3, name)
        assert_same_step(state.ema_params[name], ref_ema[name], before[name], p.grad, unfactored, g_tol, 5e-3,
                         name)
