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


# ---------------------------------------------------------------------------
# the 3D SE(3) model: weights/diffusion3d_easy at step 12000 and the held-out
# protocol of scripts/tpu_eval_3d.py that evaluated it
# (results/diagnostics/eval3d_easy12k.json)

CHECKPOINT_3D = ROOT / "weights" / "diffusion3d_easy"
STEP_3D = 12000
ASSET_3D = ROOT / "diffassemble_tpu_torch" / "assets" / "diffusion3d_easy12000.npz"
# the protocol's arguments (scripts/tpu_queue_r5h.sh:73-77 with NPTS=512, WBOOST=3)
PROTOCOL_3D = dict(test_n=64, batch=16, num_points=512, max_num_part=8, min_num_part=2, wall_detail=0.08,
                   wall_boost=3, canonical=0.9, ratio=10, seed=0)
THRESHOLDS_3D = (0.01, 0.02, 0.05, 0.1, 0.2)


def params_3d() -> dict:
    """The checkpoint's ``eval_params`` (it has no EMA, so its live params),
    restored from a copy so that nothing is written under ``weights/``."""
    import orbax.checkpoint as ocp

    from diffassemble_tpu.train.train_state import TrainState, eval_params

    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(CHECKPOINT_3D / str(STEP_3D), Path(tmp) / str(STEP_3D))
        restored = ocp.StandardCheckpointer().restore(Path(tmp) / str(STEP_3D) / "default")
    return eval_params(TrainState(**restored))


def export_3d_assets(out_path=ASSET_3D) -> Path:
    """Write the 3D checkpoint's params in f32 with its config and the
    protocol's arguments (JSON strings ``config`` and ``protocol``) and the
    step."""
    import json

    from flax.traverse_util import flatten_dict

    arrays = {"/".join(k): np.asarray(v, dtype=np.float32) for k, v in flatten_dict(params_3d()).items()}
    arrays.update(
        config=np.array(json.dumps(json.loads((CHECKPOINT_3D / "config.json").read_text()), sort_keys=True)),
        protocol=np.array(json.dumps(PROTOCOL_3D, sort_keys=True)),
        step=np.array(STEP_3D, dtype=np.int64),
    )
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **arrays)
    return out_path


def protocol_dataset_3d(test_n: int = PROTOCOL_3D["test_n"]):
    """The protocol's held-out corpus, built by the JAX package's copy of the
    data module (as ``scripts/tpu_eval_3d.py`` builds it)."""
    from diffassemble_tpu.data.breaking_bad import get_dataset_3d

    p = PROTOCOL_3D
    _, test_ds, _ = get_dataset_3d(
        "synthetic", train_n=4, test_n=test_n, max_num_part=p["max_num_part"], min_num_part=p["min_num_part"],
        num_points=p["num_points"], seed=p["seed"], canonical=p["canonical"], voronoi=True,
        wall_detail=p["wall_detail"], wall_boost=p["wall_boost"], wall_surface=False, wall_freq=14.0)
    return test_ds


def jax_reference_3d(compute_dtype: str = "bfloat16", test_n: int = PROTOCOL_3D["test_n"],
                     params: dict | None = None, out=None) -> dict:
    """``scripts/tpu_eval_3d.py``'s sampler metrics (ratio 10, no gauge
    alignment, no refinement) of the 3D checkpoint through the JAX package on
    this host, in ``compute_dtype``: n_parts, rmse_t, rmse_r, gd_r, part_acc
    at each threshold, the CD percentiles, plus ``final`` (the sampled poses
    of every batch). ``out``, when given, gets the result as an npz
    (``final`` and the JSON ``metrics``).

        JAX_PLATFORMS=cpu python -c "from tests.torch_assets import jax_reference_3d; \\
            print(jax_reference_3d('bfloat16'))"

    takes about two and a half minutes on a CPU for the 64 objects."""
    import dataclasses
    import json

    import jax
    import jax.numpy as jnp

    from diffassemble_tpu.data.batch import FragmentBatch
    from diffassemble_tpu.data.breaking_bad import collate_fragments
    from diffassemble_tpu.models import losses_3d
    from diffassemble_tpu.models.diffusion_3d import Diffusion3D, Diffusion3DConfig
    from diffassemble_tpu.ops import so3
    from diffassemble_tpu.ops.knn import chamfer_distance

    p = PROTOCOL_3D
    base = json.loads((CHECKPOINT_3D / "config.json").read_text())
    cfg = dataclasses.replace(Diffusion3DConfig(**base), compute_dtype=compute_dtype, encoder_init="",
                              inference_ratio=p["ratio"])
    model = Diffusion3D(cfg)
    params = params_3d() if params is None else params
    test_ds = protocol_dataset_3d(test_n)

    @jax.jit
    def run(batch):
        final, _ = model.sample(params, batch, jax.random.PRNGKey(7))
        pred_q, pred_t = final[..., :4], final[..., 4:7]
        gt_q, gt_t = batch.x0[..., :4], batch.x0[..., 4:7]
        v = batch.node_mask
        d1, d2 = chamfer_distance(losses_3d.transform_pc(pred_t, pred_q, batch.pcds),
                                  losses_3d.transform_pc(gt_t, gt_q, batch.pcds))
        cd = jnp.mean(d1, axis=-1) + jnp.mean(d2, axis=-1)
        gd = so3.geodesic_distance_rmat(so3.quaternion_to_matrix(pred_q), so3.quaternion_to_matrix(gt_q))
        return {"final": final, "cd": cd, "gd": gd, "rmse_t": losses_3d.trans_rmse(pred_t, gt_t, v),
                "rmse_r": losses_3d.rot_euler_rmse(pred_q, gt_q, v)}

    rng = np.random.default_rng(p["seed"])
    cds, gds, rts, rrs, finals = [], [], [], [], []
    for lo in range(0, len(test_ds), p["batch"]):
        samples = [test_ds[i] for i in range(lo, min(lo + p["batch"], len(test_ds)))]
        nb = collate_fragments(samples, p["max_num_part"], rng=rng)
        r = jax.device_get(run(FragmentBatch(*[jnp.asarray(a) for a in nb])))
        mask = nb.node_mask
        cds.append(r["cd"][mask])
        gds.append(r["gd"][mask])
        rts.append(r["rmse_t"])
        rrs.append(r["rmse_r"])
        finals.append(np.asarray(r["final"]))
    cd, gd = np.concatenate(cds), np.concatenate(gds)
    metrics = {
        "n_parts": int(cd.size),
        "rmse_t": float(np.mean(np.concatenate(rts).astype(np.float64))),
        "rmse_r": float(np.mean(np.concatenate(rrs).astype(np.float64))),
        "gd_r": float(gd.mean()),
        "part_acc": {str(t): float((cd < t).mean()) for t in THRESHOLDS_3D},
        "cd_percentiles": {str(q): float(np.percentile(cd, q)) for q in (5, 10, 25, 50, 75, 90)},
    }
    if out is not None:
        np.savez(out, final=np.concatenate(finals), metrics=np.array(json.dumps(metrics)))
    return {**metrics, "final": np.concatenate(finals)}


def knn_agreement_3d(n_objects: int = PROTOCOL_3D["batch"], compute_dtype: str = "bfloat16") -> dict:
    """How often the port's VN-DGCNN picks other neighbours than the JAX
    package's, on the protocol's first ``n_objects`` objects with the trained
    encoder, both on this CPU in ``compute_dtype``: for each of the three
    graph layers, the share of points whose set of k = 20 neighbours differs
    (``end_to_end``: each package on its own features; ``same_input``: both
    kNN functions on the JAX package's features).

        JAX_PLATFORMS=cpu python -c "from tests.torch_assets import knn_agreement_3d; print(knn_agreement_3d())"
    """
    import json

    import jax
    import jax.numpy as jnp
    import torch

    from diffassemble_tpu.data.breaking_bad import collate_fragments
    from diffassemble_tpu.nn.vn import VN_DGCNN as JVN
    from diffassemble_tpu.ops.knn import knn_indices as jknn
    from diffassemble_tpu_torch import convert
    from diffassemble_tpu_torch.nn.vn import VN_DGCNN
    from diffassemble_tpu_torch.ops.knn import knn_indices as tknn
    from diffassemble_tpu_torch.utils.params import load_params

    p = PROTOCOL_3D
    tree = load_params(ASSET_3D)
    assert json.loads(str(tree["config"]))["backbone"] == "vn_dgcnn_rich"
    test_ds = protocol_dataset_3d(n_objects)
    nb = collate_fragments([test_ds[i] for i in range(n_objects)], p["max_num_part"],
                           rng=np.random.default_rng(p["seed"]))
    pts = nb.pcds[nb.node_mask]  # (clouds, N, 3), the valid parts
    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    jm = JVN(feat_dim=128, both=True, pool="mean_maxnorm", dtype=jdt)
    params = jax.tree.map(jnp.asarray, tree["encoder"])
    _, inter = jax.jit(lambda x: jm.apply({"params": params}, x, capture_intermediates=True))(jnp.asarray(pts))
    inter = inter["intermediates"]
    tm = VN_DGCNN(feat_dim=128, both=True, pool="mean_maxnorm",
                  dtype=torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32)
    state = convert.convert_params({"encoder": tree["encoder"]})
    tm.load_state_dict({k[len("encoder."):]: v for k, v in state.items()}, strict=True)
    outs = {}
    for i in (1, 3):
        tm.layers[i].register_forward_hook(lambda m, a, o, i=i: outs.__setitem__(i, o))
    with torch.no_grad():
        tm(torch.tensor(pts))

    def flat(x):
        return x.reshape(*x.shape[:2], -1)

    def differ(a, b):
        return float((np.sort(np.asarray(a), -1) != np.sort(np.asarray(b), -1)).any(-1).mean())

    j_in = [jnp.asarray(pts, jdt)] + [flat(inter[f"VNLinearLeakyReLU_{i}"]["__call__"][0].mean(axis=2))
                                      for i in (1, 3)]
    t_in = [torch.tensor(pts).to(tm.compute_dtype)] + [
        flat(outs[i].float().mean(2).to(tm.compute_dtype)) for i in (1, 3)]
    out = {"clouds": int(pts.shape[0]), "points": int(pts.shape[1]), "k": tm.n_knn, "compute_dtype": compute_dtype}
    for layer, (ja, ta) in enumerate(zip(j_in, t_in), start=1):
        want = jknn(ja, tm.n_knn)
        same = tknn(torch.tensor(np.asarray(ja.astype(jnp.float32))).to(tm.compute_dtype), tm.n_knn)
        out[f"layer{layer}"] = {"end_to_end": differ(tknn(ta, tm.n_knn), want), "same_input": differ(same, want)}
    return out


def jax_loss_3d(compute_dtype: str = "bfloat16") -> dict[str, float]:
    """The JAX package's training loss dict of the 3D checkpoint (the asset's
    params) in ``compute_dtype`` on the batch and draws of
    ``chip_smoke.loss_inputs_3d``: the 3D training run's first batch and
    numpy draws, handed to the JAX loss in place of its own
    (``jax.random.randint``, ``normal`` and ``uniform`` give them in the
    order the loss draws). ``chip_smoke.JAX_CPU_LOSS_3D`` holds the values.

        JAX_PLATFORMS=cpu python -c "from tests.torch_assets import jax_loss_3d; print(jax_loss_3d('bfloat16'))"
    """
    import dataclasses
    import json

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from diffassemble_tpu.data.batch import FragmentBatch
    from diffassemble_tpu.models.diffusion_3d import Diffusion3D, Diffusion3DConfig
    from diffassemble_tpu_torch.utils.params import load_params

    nb, draws = chip_smoke.loss_inputs_3d()
    tree = load_params(ASSET_3D)
    cfg = dataclasses.replace(Diffusion3DConfig(**json.loads(str(tree["config"]))), compute_dtype=compute_dtype,
                              encoder_init="")
    params = jax.tree.map(jnp.asarray, {k: v for k, v in tree.items() if isinstance(v, dict)})
    model = Diffusion3D(cfg)
    queue = {"randint": [draws["t_graph"].astype(np.int32)], "normal": [draws["noise_tr"], draws["rot_axes"]],
             "uniform": [draws["rot_u"]]}

    def given(name):
        return lambda *args, **kwargs: jnp.asarray(queue[name].pop(0))

    with mock.patch.object(jax.random, "randint", given("randint")), \
            mock.patch.object(jax.random, "normal", given("normal")), \
            mock.patch.object(jax.random, "uniform", given("uniform")):
        _, out = jax.jit(model.loss)(params, FragmentBatch(*[jnp.asarray(a) for a in nb]), jax.random.PRNGKey(0))
    assert not any(queue.values()), "the JAX loss drew other values than the given draws"
    return {k: float(v) for k, v in out.items()}


def vn_dgcnn_conditioning(draws: int = 60) -> dict:
    """How far the seeded narrow VN-DGCNN of
    ``tests/test_torch_3d.py::test_vn_dgcnn_matches[kwargs0]`` (both,
    mean_maxnorm; its points, weights and 1e-3 tolerance) is from the JAX
    package's, and why it is fragile, on this CPU:

    - ``err_by_threads``: the port's largest error over the JAX output's
      largest entry at 1, 2, 4 and 8 torch threads, and whether those outputs
      are bit-identical (``threads_bit_identical``);
    - ``ulp_moves``: over ``draws`` draws of one-ulp noise (each coordinate
      times 1 + {-1, 0, 1}·2⁻²³), how far the port's output moves, over its
      largest entry: median, max and the share above the test's 1e-3;
    - ``norm_gain``: for the draw of median move, each VNNorm's output move
      over its input's (both over their largest entry), layer by layer.

        JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests'); from torch_assets import vn_dgcnn_conditioning; print(vn_dgcnn_conditioning())"
    """
    import jax.numpy as jnp
    import torch

    from diffassemble_tpu_torch.nn.vn import VN_DGCNN
    from test_torch_3d import JVN, _init_shapes, _load, seeded_tree

    kwargs = dict(feat_dim=16, n_knn=8, both=True, pool="mean_maxnorm")
    pts = np.random.default_rng(3).standard_normal((3, 64, 3)).astype(np.float32)
    jm = JVN(**kwargs)
    params = seeded_tree(_init_shapes(jm, jnp.asarray(pts)), 4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(pts)))
    tm = VN_DGCNN(**kwargs)
    _load(tm, params, "encoder")
    seen = {}

    def keep(i):
        def hook(module, inputs, output):
            seen[i, "in"], seen[i, "out"] = (t.detach().double().clone() for t in (inputs[0], output))
        return hook

    for i, layer in enumerate(tm.layers):
        layer.norm.register_forward_hook(keep(i))

    def forward(p):
        seen.clear()
        with torch.no_grad():
            return tm(torch.tensor(p)).numpy(), dict(seen)

    threads, outs = torch.get_num_threads(), {}
    try:
        for n in (1, 2, 4, 8):
            torch.set_num_threads(n)
            outs[n] = forward(pts)[0]
    finally:
        torch.set_num_threads(threads)
    scale = np.abs(want).max()
    base, base_seen = forward(pts)
    moves, runs = [], []
    for s in range(draws):
        noise = np.random.default_rng(1000 + s).choice([-1, 0, 1], size=pts.shape)
        out, got = forward(pts * (1 + 2.0**-23 * noise).astype(np.float32))
        moves.append(float(np.abs(out - base).max() / scale))
        runs.append(got)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    mid = runs[int(np.argsort(moves)[len(moves) // 2])]
    return {
        "err_by_threads": {n: float(np.abs(o - want).max() / scale) for n, o in outs.items()},
        "threads_bit_identical": all(np.array_equal(o, outs[1]) for o in outs.values()),
        "ulp_moves": {"median": float(np.median(moves)), "max": max(moves),
                      "share_above_1e-3": float(np.mean(np.array(moves) > 1e-3))},
        "norm_gain": {i: rel(mid[i, "out"], base_seen[i, "out"]) / max(rel(mid[i, "in"], base_seen[i, "in"]), 1e-30)
                      for i in range(len(tm.layers))},
    }
