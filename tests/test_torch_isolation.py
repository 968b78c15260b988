"""The port stands alone: it imports nothing of JAX, its relatives, PIL or the
JAX package, and its entry points do not run on the CPU unless asked to."""

import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "diffassemble_tpu_torch"

_REFUSE = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "PIL", "trimesh", "diffassemble_tpu")

    def blocked(name):
        return name.split(".")[0] in BLOCKED

    for name in [m for m in sys.modules if blocked(m)]:  # preloaded by a site hook
        del sys.modules[name]

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[1])
    """
)

_CHILD = _REFUSE + textwrap.dedent(
    """
    import diffassemble_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(diffassemble_tpu_torch.__path__, "diffassemble_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    loaded = sorted(m for m in sys.modules if blocked(m))
    assert not loaded, loaded

    import torch
    from diffassemble_tpu_torch.cli.serve import PuzzleSolver
    from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
    if not torch.cuda.is_available():
        for entry in (Diffusion2D, PuzzleSolver):
            try:
                entry(Diffusion2DConfig())
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
            else:
                raise AssertionError(f"{entry.__name__} ran on the CPU without being asked to")
    print("modules", len(names))
    """
)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("module", ["parallel", "parallel.distributed", "parallel.mesh", "parallel.dryrun",
                                    "utils.deadline", "utils.profiling", "utils.viz", "cli.train_device",
                                    "data.breaking_bad", "ops.so3", "ops.knn", "nn.vn", "nn.pointnet",
                                    "nn.relpose", "models.diffusion_3d", "models.losses_3d", "train.heldout3d",
                                    "cli.train_3d", "nn.gnn", "nn.correspondence", "models.refine3d", "convert",
                                    "nn.visual", "models.diffusion_2d_discrete", "models.diffusion_2d_angle",
                                    "train.heldout", "cli.serve", "cli.evaluate", "cli.preprocess",
                                    "cli.train_2d_missing", "nn.efficientnet", "data.datasets"])
def test_training_path_modules_import_alone_without_jax_or_pil(module):
    """Each module of the device-resident training path, of data-parallel
    training and of the 3D paths (the point encoders, split message passing,
    the refinement, the correspondence head and the readers of the 3D
    assets: ``train.heldout3d`` and ``convert``), imported alone in a fresh
    process, loads nothing of JAX, its relatives, PIL, trimesh or the JAX
    package (``utils.viz`` imports PIL when it draws, ``data.datasets`` when
    it opens an image folder or resizes, never at import; the real
    Breaking-Bad loader imports trimesh when it reads a mesh)."""
    child = _REFUSE + textwrap.dedent(
        f"""
        importlib.import_module("diffassemble_tpu_torch.{module}")
        loaded = sorted(m for m in sys.modules if blocked(m))
        assert not loaded, loaded
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", child, str(ROOT)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.split()[-1] == "ok", res.stderr


def test_every_3d_asset_loads_without_jax():
    """Each committed trained 3D checkpoint loads strictly into its model in
    a fresh process that refuses JAX and the JAX package."""
    child = _REFUSE + textwrap.dedent(
        """
        from diffassemble_tpu_torch.train.heldout3d import ASSETS, model_from_asset
        for name in ASSETS:
            model, cfg, protocol, step = model_from_asset(name, "cpu")
            assert step > 0 and protocol["test_n"] == 64, (name, step, protocol)
        loaded = sorted(m for m in sys.modules if blocked(m))
        assert not loaded, loaded
        print(len(ASSETS))
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", child, str(ROOT)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.split()[-1] == "4", res.stderr


def test_every_2d_asset_loads_without_jax():
    """Each committed trained 2D checkpoint beside the flagship loads
    strictly into its model in a fresh process that refuses JAX and the JAX
    package, with its protocol, draws and the JAX package's CPU figures."""
    child = _REFUSE + textwrap.dedent(
        """
        from diffassemble_tpu_torch.train.heldout import ASSETS, asset_adj, load_asset
        for name in ASSETS:
            model, cfg, protocol, extras = load_asset(name, "cpu")
            assert cfg.backbone == "resnet18equiv" and protocol["eval_n"] == 64, (name, protocol)
            assert extras["heldout_rot_k"].shape[0] == 64 and "jax_cpu_bfloat16" in extras
            adj = asset_adj(extras)
            assert adj is None or adj.shape == (36, 36)
        loaded = sorted(m for m in sys.modules if blocked(m))
        assert not loaded, loaded
        print(len(ASSETS))
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", child, str(ROOT)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.split()[-1] == "2", res.stderr


def test_port_sources_name_no_jax_module():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b|flax|orbax|diffassemble_tpu(?!_torch)", re.M)
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0)}" for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_without_the_repo(alone, tmp_path):
    """Without a CUDA card, or copied alone into an empty directory, the smoke
    script exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: the script would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=300,
                         cwd=script.parent)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
