"""The three other trained 3D checkpoints as committed assets
(``diffassemble_tpu_torch/assets/``): the exporter rebuilds each bit for
bit, and each runs its own protocol (``train/heldout3d.py``: raw,
gauge-aligned and, for ``diffusion3d_wallsurf``, refined rows) on the
protocol's first two objects in f32 as the JAX package runs it
(``tests/torch_assets.py:jax_reference_3d``, the script's code on the same
weights).

Tolerances (f32, both on the CPU), about five times the largest
difference measured over the three: rmse_t 1e-3, rmse_r 0.15°, gd_r 5e-3
(measured 2.0e-4, 0.030°, 8.4e-4, all ``diffusion3d_relpose``: its
canonical 0.6 corpus meets the trained VN encoder where it amplifies
rounding most, ``tests/test_torch_3d_encoders.py``); part_acc equal at
every threshold; the gauge-aligned rmse_t and gd_r as the raw ones
(measured 1.4e-4, 8.5e-4); the refined row 2e-3, 2° and 1e-2 (measured
5.2e-4, 0.44°, 2.3e-3: 60 ICP iterations from poses that differ by
rounding).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffassemble_tpu_torch.train import heldout3d
from diffassemble_tpu_torch.utils.params import load_params
from torch_assets import ASSETS_3D, asset_path_3d, export_3d_assets, jax_reference_3d

OTHERS = ("diffusion3d_relpose", "diffusion3d_wallsurf", "diffusion3d_vndgcnn")


@pytest.mark.parametrize("name", OTHERS)
def test_export_rebuilds_the_committed_asset(name, tmp_path):
    rebuilt = export_3d_assets(tmp_path / "asset.npz", name=name)
    with np.load(asset_path_3d(name)) as want, np.load(rebuilt) as got:
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            a, b = want[key], got[key]
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key
    assert heldout3d.ASSETS[name] == asset_path_3d(name)
    _, _, protocol, step = heldout3d.model_from_asset(name, "cpu")
    assert (step, protocol) == ASSETS_3D[name]


@pytest.mark.parametrize("name", OTHERS)
def test_asset_protocol_on_two_objects_matches_the_jax_package(name):
    tree = load_params(asset_path_3d(name))
    params = jax.tree.map(jnp.asarray, {k: v for k, v in tree.items() if isinstance(v, dict)})
    want = jax_reference_3d("float32", test_n=2, params=params, name=name)
    model, cfg, protocol, _ = heldout3d.model_from_asset(name, "cpu", "float32")
    assert json.loads(str(tree["config"]))["backbone"] == cfg.backbone
    got = heldout3d.run_protocol(model, protocol, test_n=2)
    assert got["n_parts"] == want["n_parts"] and got["ratio"] == want["ratio"] == 10
    for key, tol in (("rmse_t", 1e-3), ("rmse_r", 0.15), ("gd_r", 5e-3)):
        assert abs(got[key] - want[key]) <= tol, key
    assert got["part_acc"] == want["part_acc"]
    for key, tol in (("rmse_t", 1e-3), ("gd_r", 5e-3)):
        assert abs(got["gauge_aligned"][key] - want["gauge_aligned"][key]) <= tol, key
    assert got["gauge_aligned"]["part_acc"] == want["gauge_aligned"]["part_acc"]
    assert ("refined" in got) == ("refined" in want) == (name == "diffusion3d_wallsurf")
    if "refined" in want:
        for key, tol in (("rmse_t", 2e-3), ("rmse_r", 2.0), ("gd_r", 1e-2)):
            assert abs(got["refined"][key] - want["refined"][key]) <= tol, key
