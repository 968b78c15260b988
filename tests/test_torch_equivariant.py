"""The port's equivariant encoders (``nn/visual.py``) against the JAX
package's, on the CPU in f32: the four group convolutions, OrientationNorm in
its three modes, the calibration's pooling, the ResNets 18/34 (small depth)
and 50 on 16×16 patches, rot90 (p4) and D4 (p4m) equivariance, features of
the pose-pretrained ``weights/resnet18equiv_pose6.npz`` on real 32 px
patches, a ``norm_stats.npz`` of the JAX package's loaded by the port, and
the 2D model's ``all_equivariant`` and frozen-statistics features and its
``init`` from an equivariant ``encoder_init``.

Tolerances: each group convolution within 1e-5 of the output's largest
entry (one conv over the same big kernel in another summation order);
OrientationNorm and the calibrated statistics within 1e-5; the ResNets and
the model's features within 1e-4 (up to 20 layers of convolutions and
norms); equivariance within 1e-5 of the largest entry (f32 rounding only);
the calibration's pooling exact against the same batch statistics pooled in
numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.nn import visual as jv
from diffassemble_tpu.utils.params import load_params as jload
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.nn import visual as tv
from torch_parity import ROOT, seeded_params


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _nchw(x: np.ndarray) -> torch.Tensor:
    """(B, H, W[, G], C) → (B, G·C, H, W)."""
    b, h, w = x.shape[:3]
    return torch.tensor(x).reshape(b, h, w, -1).permute(0, 3, 1, 2)


def _nhwgc(y: torch.Tensor, g: int) -> np.ndarray:
    b, _, h, w = y.shape
    return y.detach().permute(0, 2, 3, 1).reshape(b, h, w, g, -1).numpy()


def _load(module: torch.nn.Module, params: dict) -> None:
    state = convert.convert_params({"encoder": params})
    module.load_state_dict({k[len("encoder."):]: v for k, v in state.items()}, strict=True)


@pytest.mark.parametrize("name, in_shape, k, stride", [
    ("Z2", (2, 9, 9, 3), 3, 1), ("Z2", (2, 8, 8, 3), 3, 2), ("P4", (2, 8, 8, 4, 5), 3, 2),
    ("P4", (2, 7, 7, 4, 5), 3, 2), ("P4", (2, 8, 8, 4, 5), 1, 2), ("Z2M", (2, 8, 8, 3), 3, 1),
    ("P4M", (2, 8, 8, 8, 5), 3, 2),
])
def test_group_conv_matches(name, in_shape, k, stride):
    """Odd and even inputs at stride 2 (XLA's asymmetric "SAME"), 1×1 and 3×3."""
    jm = getattr(jv, f"GroupConv{name}")(6, k, stride)
    x = np.random.default_rng(1).standard_normal(in_shape).astype(np.float32)
    params = seeded_params(jm, 2, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = getattr(tv, f"GroupConv{name}")(in_shape[-1], 6, k, stride)
    tm.kernel.data = torch.tensor(np.asarray(params["kernel"]))
    with torch.no_grad():
        got = _nhwgc(tm(_nchw(x)), want.shape[3])
    _close(got, want, 1e-5)


def _norm_input(seed=3):
    return (np.random.default_rng(seed).standard_normal((3, 5, 5, 4, 6)) * 2 + 0.5).astype(np.float32)


def test_orientation_norm_in_each_mode():
    """Batch statistics; the frozen ``norm_stats``; recording (the sown mean
    and E[x²])."""
    x = _norm_input()
    jm = jv.OrientationNorm()
    params = seeded_params(jm, 4, jnp.asarray(x))
    tm = tv.OrientationNorm(6)
    tm.weight.data, tm.bias.data = (torch.tensor(np.asarray(params[k])) for k in ("scale", "bias"))
    want, sown = jm.apply({"params": params}, jnp.asarray(x), mutable=["norm_stats"])
    tm.recorded = []
    with torch.no_grad():
        got = tm(_nchw(x))
    _close(_nhwgc(got, 4), want, 1e-5)
    (mean, sq_mean), = tm.recorded
    _close(mean, np.asarray(sown["norm_stats"]["mean"]).reshape(-1), 1e-5)
    _close(sq_mean, np.asarray(sown["norm_stats"]["sq_mean"]).reshape(-1), 1e-5)
    # frozen: another input normalised by fixed statistics
    stats = {"mean": (np.arange(6, dtype=np.float32) * 0.1).reshape(1, 1, 1, 1, 6),
             "var": (1.0 + np.arange(6, dtype=np.float32)).reshape(1, 1, 1, 1, 6)}
    x2 = _norm_input(5)
    want = jm.apply({"params": params, "norm_stats": stats}, jnp.asarray(x2))
    tm.recorded = None
    tm.frozen_mean, tm.frozen_var = (torch.tensor(stats[k]).reshape(-1) for k in ("mean", "var"))
    with torch.no_grad():
        got = tm(_nchw(x2))
    _close(_nhwgc(got, 4), want, 1e-5)


def _small_resnet(blocks=(1, 1, 1, 1)):
    return jv.EquivariantResNet(blocks=blocks), tv.EquivariantResNet(blocks, patch_size=16)


def _patches(n, size=16, seed=6):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)


def test_calibration_pools_the_batch_moments():
    """Two batches of different content: the pooled statistics against the
    JAX package's, and exactly the mean of the port's own batch moments
    with the variance E[x²] − mean² clamped at 0."""
    jm, tm = _small_resnet()
    batches = [_patches(4, seed=6), _patches(4, seed=7) * 0.5]
    params = seeded_params(jm, 8, jnp.asarray(batches[0]))
    _load(tm, params)
    want = jv.calibrate_norm_stats(jm, params, [jnp.asarray(b) for b in batches])
    layers = tv.norm_layers(tm)
    for _, m in layers:
        m.recorded = []
    with torch.no_grad():
        for b in batches:
            tm(torch.tensor(b))
    moments = {p: [(a.numpy(), s.numpy()) for a, s in m.recorded] for p, m in layers}
    for _, m in layers:
        m.recorded = None
    got = tv.calibrate_norm_stats(tm, batches)
    flat_got, flat_want = tv._flat(got), tv._flat(jax.device_get(want))
    assert flat_got.keys() == flat_want.keys() and len(flat_got) == 2 * len(layers)
    for key, v in flat_got.items():
        _close(v.numpy(), flat_want[key], 1e-5)
    for path, ms in moments.items():
        mean = np.stack([a for a, _ in ms]).mean(0)
        sq = np.stack([s for _, s in ms]).mean(0)
        assert np.array_equal(flat_got[f"{path}/mean"].numpy().reshape(-1), mean)
        assert np.array_equal(flat_got[f"{path}/var"].numpy().reshape(-1), np.maximum(sq - mean * mean, 0.0))


@pytest.mark.parametrize("depth", ["18", "34", "50"])
def test_equivariant_resnet_matches(depth):
    """ResNet18 and 34 at (1, 1, 1, 1) and (1, 2, 1, 1) blocks, ResNet50 at its
    depth, on 16×16 patches."""
    if depth == "50":
        jm, tm = jv.EquivariantResNet50(), tv.EquivariantResNet50(patch_size=16)
    else:
        jm, tm = _small_resnet((1, 1, 1, 1) if depth == "18" else (1, 2, 1, 1))
    x = _patches(3)
    params = seeded_params(jm, 9, jnp.asarray(x))
    _load(tm, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    assert got.shape == (3, 1088)
    _close(got, want, 1e-4)


def _spin(t: torch.Tensor, g: tuple, group: int) -> torch.Tensor:
    """D4 element g on NCHW (B, |G|·C, H, W) features: spatially, and on the
    group axis (output element h takes input element g⁻¹∘h); on plain
    images (group 1) spatially only."""
    m, r = g
    t = torch.rot90(t, r, dims=(2, 3))
    t = torch.flip(t, dims=(3,)) if m else t
    if group == 1:
        return t
    elements = tv._D4 if group == 8 else tv._D4[:4]
    perm = [elements.index(tv._d4_mul(tv._d4_inv(g), h)) for h in elements]
    return t.reshape(t.shape[0], group, -1, *t.shape[2:])[:, perm].reshape(t.shape)


@pytest.mark.parametrize("name", ["Z2", "P4", "Z2M", "P4M"])
def test_group_conv_is_equivariant(name):
    """p4: f(rot90(x)) = roll(rot90(f(x)), 1, orientation) for each rotation;
    p4m: the same for every element of D4 (stride 1, where "SAME" is
    symmetric)."""
    cls = getattr(tv, f"GroupConv{name}")
    torch.manual_seed(0)
    tm = cls(3, 5, 3, 1)
    tm.kernel.data.normal_()
    x = torch.randn(2, 3 * tm.in_group, 9, 9)
    elements = tv._D4[1:] if tm.group == 8 else tv._D4[1:4]
    with torch.no_grad():
        fx = tm(x)
        scale = float(fx.abs().max())
        for g in elements:
            err = float((tm(_spin(x, g, tm.in_group)) - _spin(fx, g, tm.group)).abs().max())
            assert err <= 1e-5 * scale, (g, err / scale)
    if tm.group == 4:  # the rotation by one quarter is the roll of the orientation axis by one
        rolled = torch.rot90(fx, 1, dims=(2, 3)).reshape(2, 4, 5, 9, 9).roll(1, 1).reshape(fx.shape)
        assert torch.equal(rolled, _spin(fx, (0, 1), 4))


def _real_patches(n: int) -> np.ndarray:
    """``n`` 32 px pieces of one synthetic 6×6 puzzle (the recipe's images)."""
    from diffassemble_tpu_torch.data.datasets import SyntheticImages
    from diffassemble_tpu_torch.data.patchify import patchify

    img = SyntheticImages((192, 192), n=1, seed=1000, cache=False)[0]
    return patchify(np.asarray(img, np.float32), 6, 6, 32)[:n].astype(np.float32)


def test_pose_pretrained_encoder_features_match():
    """``weights/resnet18equiv_pose6.npz`` (the discrete checkpoint's
    encoder_init) on 8 real patches: the converter maps every leaf."""
    tree = jload(ROOT / "weights" / "resnet18equiv_pose6.npz")["encoder"]
    x = _real_patches(8)
    want = np.asarray(jv.EquivariantResNet18().apply({"params": tree}, jnp.asarray(x)))
    tm = tv.EquivariantResNet18()
    _load(tm, tree)
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    _close(got, want, 1e-4)


def test_jax_norm_stats_npz_loads_and_freezes(tmp_path):
    """A ``norm_stats.npz`` written by the JAX package's ``save_norm_stats``
    loads in the port, and the frozen features match the JAX package's."""
    jm, tm = _small_resnet()
    calib, x = _patches(5, seed=11), _patches(2, seed=12)
    params = seeded_params(jm, 13, jnp.asarray(x))
    _load(tm, params)
    stats = jv.calibrate_norm_stats(jm, params, [jnp.asarray(calib)])
    jv.save_norm_stats(tmp_path / "norm_stats.npz", stats)
    want = np.asarray(jm.apply({"params": params, "norm_stats": stats}, jnp.asarray(x)))
    loaded = tv.load_norm_stats(tmp_path / "norm_stats.npz")
    tv.set_norm_stats(tm, loaded)
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    _close(got, want, 1e-4)
    tv.save_norm_stats(tmp_path / "again.npz", loaded)
    with np.load(tmp_path / "norm_stats.npz") as a, np.load(tmp_path / "again.npz") as b:
        assert sorted(a.files) == sorted(b.files) and all(np.array_equal(a[k], b[k]) for k in a.files)
    tv.set_norm_stats(tm, None)
    assert all(m.frozen_mean is None for _, m in tv.norm_layers(tm))
    with pytest.raises(ValueError, match="norm_stats"):
        tv.set_norm_stats(tm, {"OrientationNorm_0": loaded["OrientationNorm_0"]})


@pytest.mark.parametrize("all_equivariant", [False, True])
def test_model_features_with_frozen_stats(all_equivariant):
    """``Diffusion2D.visual_features`` with resnet18equiv: batch statistics,
    then calibrated and frozen (``calibrate_norm_stats``), with and without
    ``all_equivariant``, against the JAX package's."""
    from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JD
    from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JC
    from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig

    cfg = dict(backbone="resnet18equiv", n_layers=1, hidden_dim=32, heads=4, virt_nodes=2,
               all_equivariant=all_equivariant)
    jmodel = JD(JC(**cfg))
    patches = (_real_patches(8).reshape(2, 4, 32, 32, 3) * 255).astype(np.uint8)
    enc = seeded_params(jmodel.encoder, 14, jnp.zeros((1, 32, 32, 3)))
    params = {"encoder": enc}
    tmodel = Diffusion2D(Diffusion2DConfig(**cfg), device="cpu")
    _load(tmodel.encoder, enc)
    with torch.no_grad():
        for step in ("batch", "frozen"):
            if step == "frozen":
                calib = [_real_patches(12)]
                jmodel.calibrate_norm_stats(params, [jnp.asarray(c) for c in calib])
                assert tmodel.calibrate_norm_stats(calib)
            want = np.asarray(jmodel.visual_features(params, jnp.asarray(patches)))
            got = tmodel.visual_features(torch.tensor(patches)).numpy()
            _close(got, want, 1e-4)
    tmodel.norm_stats = None
    assert tmodel.norm_stats is None and all(m.frozen_mean is None for _, m in tv.norm_layers(tmodel.encoder))
    assert dataclasses.asdict(tmodel.cfg)["all_equivariant"] is all_equivariant


def test_model_init_loads_an_equivariant_encoder_init():
    """``Diffusion2D.init`` with resnet18equiv takes the JAX package's
    pose-pretrained encoder npz (``encoder_init``) leaf for leaf."""
    from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig

    path = ROOT / "weights" / "resnet18equiv_pose6.npz"
    model = Diffusion2D(Diffusion2DConfig(backbone="resnet18equiv", encoder_init=str(path), n_layers=1,
                                          hidden_dim=32, heads=4, virt_nodes=2), device="cpu")
    model.init(0)
    want = convert.convert_params({"encoder": jload(path)["encoder"]})
    got = {f"encoder.{k}": v for k, v in model.encoder.state_dict().items()}
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
