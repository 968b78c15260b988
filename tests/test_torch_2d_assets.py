"""The committed trained 2D checkpoints beside the flagship
(``train/heldout.py:ASSETS``: ``diffusion2d_rot_ms`` at step 7000 and
``diffusion2d_discrete_rot6`` at step 6000) on the CPU: the exporter's tree
against the checkpoint's own, every leaf converted once, the bf16 storage
lossless for the bf16 path (the port's bf16 forward from the asset bit-equal
to its forward from the checkpoint's f32 params), the trained weights'
forward against the JAX package's, the protocols' corpora equal to the JAX
package's, and the protocols' arguments.

Tolerances: the trained forward in f32 within 1e-4 of the largest entry
(the encoder's 20 layers and the denoiser's 4); the rest exact. The ``slow`` tests (not in
tier-1) run each whole protocol on the CPU and hold it to the JAX package's
CPU bf16 figures in the asset within 0.01 of piece_acc.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.train.device_data import gather_batch, gather_batch_mixed
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.train import heldout
from diffassemble_tpu_torch.utils.params import load_params
from torch_assets import ASSETS_2D, asset_path_2d, heldout_rot_k_2d, jax_model_2d, params_2d, protocol_corpus_2d
from torch_parity import ROOT

NAMES = sorted(ASSETS_2D)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoints():
    """Each checkpoint's params restored through orbax, as numpy."""
    return {name: jax.tree.map(np.asarray, params_2d(name)) for name in NAMES}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


@pytest.mark.parametrize("name", NAMES)
def test_asset_holds_the_checkpoint_and_its_protocol(name, checkpoints):
    """Every leaf of the checkpoint, bf16-rounded where it is stored as bf16
    bits and exact otherwise; the protocol's arguments, step and draws."""
    assert heldout.ASSETS[name] == asset_path_2d(name)
    raw = load_params(asset_path_2d(name))
    extras = {k: raw.pop(k) for k in list(raw) if not isinstance(raw[k], dict)}
    want, got = _flat(checkpoints[name]), _flat(raw)
    assert got.keys() == want.keys()
    bf16 = set(map(str, extras["bfloat16_leaves"]))
    assert bf16 == {k for k in want if k.endswith(("/kernel", "/embedding"))}
    for k, w in want.items():
        if k in bf16:
            g = convert.bf16_to_f32(got[k])
            assert np.array_equal(g, torch.tensor(w).to(torch.bfloat16).float().numpy()), k
        else:
            assert got[k].dtype == np.float32 and np.array_equal(got[k], w), k
    step, protocol = ASSETS_2D[name]
    assert int(extras["step"]) == step and json.loads(str(extras["protocol"])) == protocol
    assert np.array_equal(extras["heldout_rot_k"], heldout_rot_k_2d(protocol))
    assert json.loads(str(extras["config"])) == json.loads((ROOT / "weights" / name / "config.json").read_text())
    ref = json.loads(str(extras["jax_cpu_bfloat16"]))
    assert ref["overall_nImages"] == protocol["eval_n"] and 0.0 <= ref["overall__piece_acc"] <= 1.0


@pytest.mark.parametrize("name", NAMES)
def test_converter_uses_every_leaf_of_the_2d_trees_once(name, checkpoints):
    """Each leaf of the checkpoint's tree maps to its own parameter of the
    model, and every parameter is one of them (a strict load)."""
    model, _, _, _ = heldout.load_asset(name, "cpu")
    state = convert.convert_params(checkpoints[name])
    assert len(state) == len(_flat(checkpoints[name]))
    assert state.keys() == model.state_dict().keys()
    assert all(state[k].shape == v.shape for k, v in model.state_dict().items())


def _first_call(name: str, n: int):
    """The JAX batch of the protocol's first ``n`` puzzles with its rotation draw."""
    _, p = ASSETS_2D[name]
    data = protocol_corpus_2d(p, n)
    gather = gather_batch_mixed if len(p["hw"]) > 1 else gather_batch
    return gather(data, jnp.arange(n), jax.random.fold_in(jax.random.PRNGKey(99), 0))


def _port_batch(jbatch):
    from diffassemble_tpu_torch.data import PuzzleBatch

    return PuzzleBatch(*[torch.as_tensor(np.array(a)) for a in jbatch])


def _denoise(model, batch, cfg):
    """The encoder's features and one denoiser call at t = 150 (discrete: on
    the true cells and rotation classes)."""
    from diffassemble_tpu_torch.models import diffusion_2d_discrete as td

    feats = model.visual_features(batch.patches)
    t = torch.full(batch.node_mask.shape, 150)
    if "n_classes" in cfg:
        idx = td.indices_from_positions(batch.x0[..., :2], batch.grid)
        out = model.denoise_logits(idx, t, feats, batch.adj, batch.node_mask,
                                   rot_idx=td.rot_class_from_vec(batch.x0[..., 2:4]))
        return feats, torch.cat([out["pos"], out["rot"]], -1)
    return feats, model.denoise(batch.x0, t, feats, batch.adj, batch.node_mask)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_asset_forward_is_bit_equal_to_the_f32_checkpoint(name, checkpoints):
    """The bf16 path rounds every bf16-stored leaf before its first use, so
    the asset's and the checkpoint's f32 params give the same bits."""
    model, cfg, _, _ = heldout.load_asset(name, "cpu")
    assert cfg.compute_dtype == "bfloat16"
    exact = type(model)(cfg, device="cpu")
    exact.load_state_dict(convert.convert_params(checkpoints[name]), strict=True)
    batch = _port_batch(_first_call(name, 1))
    with torch.no_grad():
        for a, b in zip(_denoise(model, batch, dataclasses.asdict(cfg)),
                        _denoise(exact, batch, dataclasses.asdict(cfg))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_trained_forward_matches_the_jax_package(name, checkpoints):
    """f32, one puzzle of the protocol's first call (6×6): the features and
    one denoiser call against the JAX package's on the checkpoint's params."""
    model, cfg, _, _ = heldout.load_asset(name, "cpu", "float32")
    model.load_state_dict(convert.convert_params(checkpoints[name]), strict=True)
    jm = jax_model_2d(name, "float32")
    jbatch = _first_call(name, 1)
    params = jax.tree.map(jnp.asarray, checkpoints[name])
    want_f = jm.visual_features(params, jbatch.patches)
    t = jnp.full(jbatch.node_mask.shape, 150)
    if "n_classes" in dataclasses.asdict(cfg):
        from diffassemble_tpu.models import diffusion_2d_discrete as jd

        out = jm.denoise_logits(params, jd.indices_from_positions(jbatch.x0[..., :2], jbatch.grid), t, want_f,
                                jbatch.adj, jbatch.node_mask, rot_idx=jd.rot_class_from_vec(jbatch.x0[..., 2:4]))
        want_o = jnp.concatenate([out["pos"], out["rot"]], -1)
    else:
        want_o = jm.denoise(params, jbatch.x0, t, want_f, jbatch.adj, jbatch.node_mask)
    with torch.no_grad():
        got_f, got_o = _denoise(model, _port_batch(jbatch), dataclasses.asdict(cfg))
    for got, want in ((got_f, want_f), (got_o, want_o)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name", NAMES)
def test_protocol_corpus_equals_the_jax_package(name):
    """The port's held-out corpus of the protocol (first call) over the
    asset's expander: patches, grid, topology and mask equal the JAX
    package's, and the committed expander is the JAX build's."""
    protocol, extras = heldout.asset_protocol(name)
    n = protocol["eval_batch"] if len(protocol["hw"]) > 1 else 4
    got = heldout.protocol_corpus(protocol, "cpu", n, heldout.asset_adj(extras))
    want = protocol_corpus_2d(protocol, n)
    for field in got._fields:
        assert np.array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field))), field
    if protocol["degree"] != "-1":
        assert heldout.asset_adj(extras).sum() < heldout.asset_adj(extras).size


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_whole_protocol_on_the_cpu(name):
    """The asset under its whole protocol on the CPU in bf16 (rot_ms about
    two minutes, discrete_rot6 about ten): piece_acc within 0.01 of the JAX
    package's CPU figure."""
    out = heldout.run_protocol(name, "cpu")
    ref = out["jax_cpu_bfloat16"]
    assert out["overall_nImages"] == ref["overall_nImages"]
    assert abs(out["overall__piece_acc"] - ref["overall__piece_acc"]) <= 0.01, (out, ref)
