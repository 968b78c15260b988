"""The flagship's assets for the port, made through the JAX package: the EMA
parameters of ``weights/diffusion2d_rot30`` at step 32000 and the draws of
bench.py's held-out protocol, in one npz that needs no JAX to read
(``diffassemble_tpu_torch/assets/diffusion2d_rot30_ema32000.npz``).

    JAX_PLATFORMS=cpu python -c "from tests.torch_assets import export_flagship_assets; export_flagship_assets()"

rewrites the committed file (about 10 s on a CPU). Its arrays:
- ``encoder/...``, ``denoiser/...``: the EMA tree, f32, keys the ``/``-joined
  flax paths (``diffassemble_tpu_torch.convert.load_jax_npz`` reads them);
- ``heldout_rot_k`` (64, 900) uint8: rows lo..lo+31 are
  ``jax.random.randint(fold_in(PRNGKey(99), lo), (32, 900), 0, 4)`` for
  lo = 0, 32, the rotations bench.py's ``gather_batch`` draws;
- ``heldout_adj_bits``: ``np.packbits`` of the (900, 900) expander that the
  JAX ``build_device_data(..., degree="10%", seed=0)`` builds;
- ``jax_version``, ``jax_threefry_partitionable``: what made the draw;
  ``step``: the checkpoint's step.

The expander's candidates are circulant graphs relabelled by a permutation,
so all five that ``expander_mask`` tries have the same Fiedler value, and
which one it keeps is decided by the rounding of ARPACK's eigenvalues, whose
start vector is random. The export fixes that start vector (``fixed_eigsh``),
as ``tests/test_torch_data.py`` does, so that the file is reproducible.
"""

from __future__ import annotations

import contextlib
import shutil
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / "weights" / "diffusion2d_rot30"
STEP = 32000
ASSET = ROOT / "diffassemble_tpu_torch" / "assets" / "diffusion2d_rot30_ema32000.npz"
HW = (30, 30)
EVAL_TOTAL, EVAL_N = 64, 32  # bench.py's held-out corpus and slice
ROT_SEED, DATA_SEED = 99, 0  # bench.py's rotation key; data.json's seed


@contextlib.contextmanager
def fixed_eigsh():
    """ARPACK started from ``default_rng(0).random(n)`` instead of its own
    random vector."""
    import scipy.sparse.linalg as sla

    orig = sla.eigsh

    def eigsh(a, *args, **kwargs):
        kwargs.setdefault("v0", np.random.default_rng(0).random(a.shape[0]))
        return orig(a, *args, **kwargs)

    with mock.patch.object(sla, "eigsh", eigsh):
        yield


def heldout_rot_k() -> np.ndarray:
    """(64, 900) uint8: bench.py's rotation draw for each held-out slice."""
    import jax

    n = HW[0] * HW[1]
    rows = [np.asarray(jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(ROT_SEED), lo), (EVAL_N, n), 0, 4))
            for lo in range(0, EVAL_TOTAL, EVAL_N)]
    return np.concatenate(rows).astype(np.uint8)


def heldout_adj() -> np.ndarray:
    """(900, 900) bool: the JAX ``build_device_data``'s expander (no images
    are needed for it: the topology comes from the seed alone)."""
    from diffassemble_tpu.train.device_data import build_device_data

    with fixed_eigsh():
        data = build_device_data(None, HW, 0, degree="10%", seed=DATA_SEED)
    return np.asarray(data.adj)


def ema_params() -> dict:
    """The checkpoint's ``eval_params`` (its EMA), restored from a copy so
    that nothing is written under ``weights/``."""
    import orbax.checkpoint as ocp

    from diffassemble_tpu.train.train_state import TrainState, eval_params

    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(CHECKPOINT / str(STEP), Path(tmp) / str(STEP))
        restored = ocp.StandardCheckpointer().restore(Path(tmp) / str(STEP) / "default")
    state = TrainState(**restored)
    if state.ema_params is None:
        raise ValueError(f"{CHECKPOINT}/{STEP} holds no EMA parameters")
    return eval_params(state)


def export_flagship_assets(out_path=ASSET) -> Path:
    import jax
    from flax.traverse_util import flatten_dict

    arrays = {"/".join(k): np.asarray(v, dtype=np.float32) for k, v in flatten_dict(ema_params()).items()}
    arrays.update(
        heldout_rot_k=heldout_rot_k(),
        heldout_adj_bits=np.packbits(heldout_adj()),
        jax_version=np.array(jax.__version__),
        jax_threefry_partitionable=np.array(bool(jax.config.jax_threefry_partitionable)),
        step=np.array(STEP, dtype=np.int64),
    )
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **arrays)
    return out_path
