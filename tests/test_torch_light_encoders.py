"""The light 2D encoders, the GCN backbone and the pretrained-features loader
against the JAX package's, on the CPU in float32.

- ``PatchConvEncoder`` ("convnet") and ``TinyPatchEncoder`` ("tiny") on
  numpy-seeded 32×32 patches and parameters, carried across by
  ``convert.py``: within 1e-5 of the largest feature.
- ``GCN`` on a mask with padded nodes and an empty row: within 1e-5 of the
  largest output.
- A ``Diffusion2D`` loss with each of "tiny", "convnet" and "gcn" on the JAX
  loss's own draws, and its gradients: the loss and its parts within 1e-5
  relative; gradients within 2e-4 of each parameter's largest entry plus
  1e-6 of the model's largest (``test_torch_train.py``'s tolerances).
- ``load_pretrained_features`` on the fake timm state dict of
  ``tests/test_convert_efficientnet.py``, converted by
  ``scripts/convert_efficientnet.py``: the loaded encoder equals the JAX
  package's after its ``init``, and its "affine" forward is the JAX one's
  within 1e-5 of the largest feature; a corrupted shape, a missing leaf and
  an extra leaf each raise ValueError, as they do in the JAX package.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JDiffusion2D
from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JConfig
from diffassemble_tpu.nn import gnn as jgnn
from diffassemble_tpu.nn import visual as jvisual
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.data import PuzzleBatch
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.nn import gnn as tgnn
from diffassemble_tpu_torch.nn import visual as tvisual
from diffassemble_tpu_torch.nn.efficientnet import load_pretrained_features
from torch_parity import CFG, ROOT, jax_draws, seeded_params, small_batch, torch_draws

sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "tests"))

from convert_efficientnet import convert as convert_timm  # noqa: E402
from test_convert_efficientnet import _fake_timm_state_dict  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(ref, out, rel=1e-5):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=rel * np.abs(ref).max(), rtol=0)


def _patches(seed, b=6):
    return np.random.default_rng(seed).random((b, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("name, jax_cls, port_cls", [
    ("convnet", jvisual.PatchConvEncoder, tvisual.PatchConvEncoder),
    ("tiny", jvisual.TinyPatchEncoder, tvisual.TinyPatchEncoder),
])
def test_light_encoder_features_match(name, jax_cls, port_cls):
    x = _patches(3)
    jm = jax_cls()
    params = seeded_params(jm, 4, jnp.zeros((1, 32, 32, 3)))
    ref = jm.apply({"params": params}, jnp.asarray(x))
    enc = tvisual.make_visual_encoder(name)
    assert type(enc) is port_cls and enc.feature_dim == 1088
    enc.load_state_dict({k[len("encoder."):]: v for k, v in convert.convert_params(
        {"encoder": jax.tree_util.tree_map(np.asarray, params)}).items()}, strict=True)
    with torch.no_grad():
        out = enc(torch.from_numpy(x))
    assert out.shape == (6, 1088)
    _close(ref, out)


def test_gcn_matches_on_padded_nodes_and_an_empty_row():
    b, n, d = 2, 7, 24
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    adj = rng.random((b, n, n)) < 0.4
    node_mask = np.ones((b, n), bool)
    node_mask[1, -2:] = False  # padded nodes
    adj &= node_mask[:, :, None] & node_mask[:, None, :]
    adj[0, 3, :] = False  # an empty row
    jm = jgnn.make_gnn("gcn", output_size=20, hidden_dim=16)
    params = seeded_params(jm, 6, jnp.zeros((1, n, d)), jnp.ones((1, n, n), bool), jnp.ones((1, n), bool))
    ref, w = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(adj), jnp.asarray(node_mask))
    assert w is None
    gcn = tgnn.make_gnn("gcn", d, 20, hidden_dim=16)
    state = convert.convert_params({"gnn": jax.tree_util.tree_map(np.asarray, params)})
    gcn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        out, weights = gcn(torch.from_numpy(x), torch.from_numpy(adj), torch.from_numpy(node_mask),
                           return_weights=True)
    assert weights is None
    _close(ref, out)


@pytest.mark.parametrize("kw", [dict(backbone="tiny"), dict(backbone="convnet"),
                                dict(backbone="efficientnet_b0", architecture="gcn")])
def test_diffusion_loss_and_gradients_match(kw):
    cfg = {**CFG, **kw}
    jm = JDiffusion2D(JConfig(**cfg))
    batch = small_batch()
    n = batch.x0.shape[1]
    params = {"encoder": seeded_params(jm.encoder, 8, jnp.zeros((1, 32, 32, 3))),
              "denoiser": seeded_params(jm.denoiser, 9, jnp.zeros((1, n, 4)), jnp.zeros((1, n), jnp.int32),
                                        jnp.zeros((1, n, 1088)), jnp.ones((1, n, n), bool), jnp.ones((1, n), bool))}
    jb = type(batch)(*[jnp.asarray(a) for a in batch])
    rng = jax.random.PRNGKey(1)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb, rng)

    model = Diffusion2D(Diffusion2DConfig(**cfg), device="cpu")
    model.load_state_dict(convert.convert_params(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    draws = jax_draws(rng, 2, batch.x0.shape, cfg["steps"], cfg["classifier_free_prob"])
    loss, aux = model.loss(PuzzleBatch(*batch).to("cpu"), **torch_draws(draws))
    loss.backward()
    assert set(aux) == set(aux_j)
    for key in aux_j:
        np.testing.assert_allclose(float(aux[key].detach()), float(aux_j[key]), rtol=1e-5, err_msg=key)
    ref = convert.convert_params(jax.tree_util.tree_map(np.asarray, grads_j))
    named = dict(model.named_parameters())
    assert ref.keys() == named.keys()
    floor = 1e-6 * max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=2e-4 * float(g.abs().max()) + floor, err_msg=name)
    if kw.get("architecture") == "gcn":
        assert type(model.denoiser.gnn) is tgnn.GCN


@pytest.fixture(scope="module")
def pretrained_npz(tmp_path_factory):
    """The fake timm state dict, converted as a real one would be."""
    out = convert_timm(_fake_timm_state_dict(np.random.default_rng(0)))
    path = tmp_path_factory.mktemp("pretrained") / "effb0.npz"
    np.savez(path, **out)
    return path, out


def test_pretrained_features_load_as_in_jax(pretrained_npz):
    """The model's ``init`` grafts the file in the JAX order and the
    affine-BN features match the JAX package's on the same patches."""
    from diffassemble_tpu.nn.efficientnet import load_pretrained_features as jload

    path, _ = pretrained_npz
    cfg = {**CFG, "visual_pretrained": True, "visual_weights": str(path)}
    jm = JDiffusion2D(JConfig(**cfg))
    shapes = jax.eval_shape(jm.encoder.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    jparams = jload({"encoder": shapes}, str(path))
    model = Diffusion2D(Diffusion2DConfig(**cfg), device="cpu")
    model.init(0)
    ref = convert.convert_params({"encoder": jax.tree_util.tree_map(np.asarray, jparams["encoder"])})
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, ref[f"encoder.{k}"]), k
    x = _patches(7)
    feats_j = jax.jit(lambda p, x: jm.encoder.apply({"params": p}, x))(jparams["encoder"], jnp.asarray(x))
    with torch.no_grad():
        feats = model.visual_features(torch.from_numpy(x)[None])[0]
    _close(feats_j, feats)


def test_pretrained_features_refuse_a_mismatch(pretrained_npz, tmp_path):
    path, out = pretrained_npz
    encoder = tvisual.make_visual_encoder("efficientnet_b0", pretrained=True)
    before = {k: v.clone() for k, v in encoder.state_dict().items()}
    bad_shape = {**out, "conv_stem/kernel": out["conv_stem/kernel"][:, :, :1]}
    missing = {k: v for k, v in out.items() if k != "bn1/bias"}
    extra = {**out, "head/kernel": np.zeros((4, 4), np.float32)}
    for label, tree in (("shape", bad_shape), ("missing", missing), ("extra", extra)):
        np.savez(tmp_path / f"{label}.npz", **tree)
        match = {"shape": r"shape mismatch at conv_stem.weight", "missing": r"missing=\['bn1.bias'\] extra=\[\]",
                 "extra": r"missing=\[\] extra=\['head.weight'\]"}[label]
        with pytest.raises(ValueError, match=match):
            load_pretrained_features(encoder, tmp_path / f"{label}.npz")
        from diffassemble_tpu.nn.efficientnet import load_pretrained_features as jload

        with pytest.raises(ValueError):
            jload({"encoder": jax.tree_util.tree_map(jnp.asarray, _jax_encoder_params(out))},
                  str(tmp_path / f"{label}.npz"))
    assert all(torch.equal(v, before[k]) for k, v in encoder.state_dict().items())  # nothing was loaded
    load_pretrained_features(encoder, path)
    assert torch.equal(encoder.conv_stem.weight, torch.from_numpy(out["conv_stem/kernel"].transpose(3, 2, 0, 1)))


def _jax_encoder_params(flat: dict) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def test_make_visual_encoder_takes_every_backbone():
    assert set(tvisual.BACKBONES) == {"efficientnet_b0", "convnet", "tiny", "resnet18equiv", "resnet34equiv",
                                      "resnet50equiv"}
    with pytest.raises(ValueError):
        tvisual.make_visual_encoder("resnet101")
    assert Path(tvisual.__file__).read_text().count("ROADMAP") == 0
