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
# the 3D SE(3) models: the trained checkpoints under weights/diffusion3d_*, each
# with the protocol of scripts/tpu_eval_3d.py that evaluated it

CHECKPOINT_3D = ROOT / "weights" / "diffusion3d_easy"
STEP_3D = 12000
ASSET_3D = ROOT / "diffassemble_tpu_torch" / "assets" / "diffusion3d_easy12000.npz"
# the protocol's arguments (scripts/tpu_queue_r5h.sh:73-77 with NPTS=512, WBOOST=3)
PROTOCOL_3D = dict(test_n=64, batch=16, num_points=512, max_num_part=8, min_num_part=2, wall_detail=0.08,
                   wall_boost=3, canonical=0.9, ratio=10, seed=0)
THRESHOLDS_3D = (0.01, 0.02, 0.05, 0.1, 0.2)
# every committed 3D checkpoint: (its step, its protocol's arguments, where the script's defaults
# (scripts/tpu_eval_3d.py:48-75) are not taken)
ASSETS_3D = {
    "diffusion3d_easy": (STEP_3D, PROTOCOL_3D),
    # scripts/tpu_queue_r5g.sh:54,65-69
    "diffusion3d_relpose": (12000, dict(test_n=64, batch=16, num_points=512, max_num_part=8, min_num_part=2,
                                        wall_detail=0.06, wall_boost=3, canonical=0.6, ratios=[10], seed=0)),
    # scripts/tpu_queue_r5i.sh:56-57,92-96: the wall-surface corpus, raw and refined
    "diffusion3d_wallsurf": (18000, dict(test_n=64, batch=16, num_points=512, max_num_part=8, min_num_part=2,
                                         wall_detail=0.08, wall_boost=3, wall_surface=1, wall_freq=5.0,
                                         canonical=0.9, ratios=[10], refine_steps=60, refine_anchor=0.01,
                                         refine_sigma0=0.2, refine_trim=0.25, seed=0)),
    # the script's defaults at the two ratios of results/diagnostics/eval3d_vndgcnn.json
    "diffusion3d_vndgcnn": (3000, dict(test_n=64, batch=16, num_points=1000, max_num_part=20, min_num_part=2,
                                       wall_detail=0.0, wall_boost=1, canonical=0.6, ratios=[10, 2], seed=0)),
}
_SCRIPT_DEFAULTS = dict(wall_surface=0, wall_freq=14.0, refine_steps=0, refine_anchor=0.05, refine_sigma0=0.2,
                        refine_trim=0.25)


def asset_path_3d(name: str = "diffusion3d_easy") -> Path:
    return ROOT / "diffassemble_tpu_torch" / "assets" / f"{name}{ASSETS_3D[name][0]}.npz"


def params_3d(name: str = "diffusion3d_easy") -> dict:
    """The checkpoint's ``eval_params`` (the 3D runs kept no EMA, so its live
    params), restored from a copy so that nothing is written under
    ``weights/``."""
    import orbax.checkpoint as ocp

    from diffassemble_tpu.train.train_state import TrainState, eval_params

    step = ASSETS_3D[name][0]
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "weights" / name / str(step), Path(tmp) / str(step))
        restored = ocp.StandardCheckpointer().restore(Path(tmp) / str(step) / "default")
    return eval_params(TrainState(**restored))


def export_3d_assets(out_path=None, name: str = "diffusion3d_easy") -> Path:
    """Write checkpoint ``name``'s params in f32 with its config and its
    protocol's arguments (JSON strings ``config`` and ``protocol``) and the
    step, to ``out_path`` (default: its committed asset). Each asset is
    rewritten by one command (orbax restore, about 10 s on a CPU):

        JAX_PLATFORMS=cpu python -c "from tests.torch_assets import export_3d_assets; \\
            export_3d_assets(name='diffusion3d_wallsurf')"

    with ``name`` one of ``ASSETS_3D``."""
    import json

    from flax.traverse_util import flatten_dict

    step, protocol = ASSETS_3D[name]
    arrays = {"/".join(k): np.asarray(v, dtype=np.float32) for k, v in flatten_dict(params_3d(name)).items()}
    arrays.update(
        config=np.array(json.dumps(json.loads((ROOT / "weights" / name / "config.json").read_text()),
                                   sort_keys=True)),
        protocol=np.array(json.dumps(protocol, sort_keys=True)),
        step=np.array(step, dtype=np.int64),
    )
    out_path = Path(out_path or asset_path_3d(name))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **arrays)
    return out_path


def protocol_dataset_3d(test_n: int | None = None, protocol: dict = PROTOCOL_3D):
    """The protocol's held-out corpus, built by the JAX package's copy of the
    data module (as ``scripts/tpu_eval_3d.py`` builds it)."""
    from diffassemble_tpu.data.breaking_bad import get_dataset_3d

    p = {**_SCRIPT_DEFAULTS, **protocol}
    _, test_ds, _ = get_dataset_3d(
        "synthetic", train_n=4, test_n=test_n or p["test_n"], max_num_part=p["max_num_part"],
        min_num_part=p["min_num_part"], num_points=p["num_points"], seed=p["seed"], canonical=p["canonical"],
        voronoi=True, wall_detail=p["wall_detail"], wall_boost=p["wall_boost"],
        wall_surface=bool(p["wall_surface"]), wall_freq=p["wall_freq"])
    return test_ds


def jax_reference_3d(compute_dtype: str = "bfloat16", test_n: int | None = None, params: dict | None = None,
                     out=None, name: str = "diffusion3d_easy", ratio: int | None = None) -> dict:
    """``scripts/tpu_eval_3d.py``'s row of checkpoint ``name`` at ``ratio``
    (default: its protocol's first) through the JAX package on this host, in
    ``compute_dtype``, on the protocol's first ``test_n`` objects (default:
    all): n_parts, rmse_t, rmse_r, gd_r, part_acc at each threshold, the CD
    percentiles, ``gauge_aligned``, ``refined`` when the protocol refines
    (the script's code, copied: it has no function to import), plus
    ``final`` (the sampled poses of every batch) and ``refined_final``.
    ``out``, when given, gets the result as an npz (``final`` and the JSON
    ``metrics``). ``chip_smoke.JAX_CPU_3D`` and ``JAX_CPU_3D_ASSETS`` hold
    the values; each is reproduced by one command:

        JAX_PLATFORMS=cpu python -c "from tests.torch_assets import jax_reference_3d; \\
            print(jax_reference_3d('bfloat16', name='diffusion3d_wallsurf'))"

    (``name='diffusion3d_vndgcnn', ratio=2`` for its second row). The easy
    checkpoint's 64 objects take about two and a half minutes on a CPU."""
    import dataclasses
    import json

    import jax
    import jax.numpy as jnp

    from diffassemble_tpu.data.batch import FragmentBatch
    from diffassemble_tpu.data.breaking_bad import collate_fragments
    from diffassemble_tpu.models import losses_3d
    from diffassemble_tpu.models.diffusion_3d import Diffusion3D, Diffusion3DConfig
    from diffassemble_tpu.models.refine3d import refine_poses
    from diffassemble_tpu.ops import so3
    from diffassemble_tpu.ops.knn import chamfer_distance

    _, protocol = ASSETS_3D[name]
    p = {**_SCRIPT_DEFAULTS, **protocol}
    if ratio is None:
        ratio = p["ratios"][0] if "ratios" in p else p["ratio"]
    base = json.loads((ROOT / "weights" / name / "config.json").read_text())
    cfg = dataclasses.replace(Diffusion3DConfig(**base), compute_dtype=compute_dtype, encoder_init="",
                              inference_ratio=ratio)
    model = Diffusion3D(cfg)
    params = params_3d(name) if params is None else params
    test_ds = protocol_dataset_3d(test_n, protocol)

    def per_part_cd(pts, pred_t, gt_t, pred_q, gt_q):
        d1, d2 = chamfer_distance(losses_3d.transform_pc(pred_t, pred_q, pts),
                                  losses_3d.transform_pc(gt_t, gt_q, pts))
        return jnp.mean(d1, axis=-1) + jnp.mean(d2, axis=-1)

    @jax.jit
    def run(batch):
        final, _ = model.sample(params, batch, jax.random.PRNGKey(7))
        pred_q, pred_t = final[..., :4], final[..., 4:7]
        gt_q, gt_t = batch.x0[..., :4], batch.x0[..., 4:7]
        v = batch.node_mask
        cd = per_part_cd(batch.pcds, pred_t, gt_t, pred_q, gt_q)
        gd = so3.geodesic_distance_rmat(so3.quaternion_to_matrix(pred_q), so3.quaternion_to_matrix(gt_q))
        # the gauge-aligned diagnostic, as the script computes it
        hp = jax.lax.Precision.HIGHEST
        pred_r, gt_r = so3.quaternion_to_matrix(pred_q), so3.quaternion_to_matrix(gt_q)
        w = v.astype(pred_r.dtype)
        m = jnp.einsum("bp,bpij,bpkj->bik", w, gt_r, pred_r, precision=hp)
        u, _, vt = jnp.linalg.svd(m)
        det = jnp.linalg.det(jnp.einsum("bij,bjk->bik", u, vt, precision=hp))
        d = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], -1)
        r0 = jnp.einsum("bij,bj,bjk->bik", u, d, vt, precision=hp)
        nv = jnp.sum(w, axis=1, keepdims=True) + 1e-9
        mean_gt = jnp.sum(gt_t * w[..., None], axis=1) / nv
        mean_pr = jnp.sum(pred_t * w[..., None], axis=1) / nv
        t0 = mean_gt - jnp.einsum("bij,bj->bi", r0, mean_pr, precision=hp)
        a_t = jnp.einsum("bij,bpj->bpi", r0, pred_t, precision=hp) + t0[:, None]
        a_r = jnp.einsum("bij,bpjk->bpik", r0, pred_r, precision=hp)
        return {"final": final, "cd": cd, "gd": gd, "rmse_t": losses_3d.trans_rmse(pred_t, gt_t, v),
                "rmse_r": losses_3d.rot_euler_rmse(pred_q, gt_q, v),
                "cd_a": per_part_cd(batch.pcds, a_t, gt_t, so3.matrix_to_quaternion(a_r), gt_q),
                "gd_a": so3.geodesic_distance_rmat(a_r, gt_r), "rmse_t_a": losses_3d.trans_rmse(a_t, gt_t, v)}

    @jax.jit
    def refine(batch, pred_q, pred_t, point_w):
        res = refine_poses(batch.pcds, batch.node_mask.astype(bool), pred_q, pred_t, steps=p["refine_steps"],
                           anchor=p["refine_anchor"], sigma0=p["refine_sigma0"], trim=p["refine_trim"],
                           point_w=point_w)
        gt_q, gt_t = batch.x0[..., :4], batch.x0[..., 4:7]
        v = batch.node_mask
        return {"final": jnp.concatenate([res.quat, res.trans], -1),
                "cd": per_part_cd(batch.pcds, res.trans, gt_t, res.quat, gt_q),
                "gd": so3.geodesic_distance_rmat(so3.quaternion_to_matrix(res.quat), so3.quaternion_to_matrix(gt_q)),
                "rmse_t": losses_3d.trans_rmse(res.trans, gt_t, v),
                "rmse_r": losses_3d.rot_euler_rmse(res.quat, gt_q, v)}

    rng = np.random.default_rng(p["seed"])
    got = {k: [] for k in ("cd", "gd", "rmse_t", "rmse_r", "final", "cd_a", "gd_a", "rmse_t_a")}
    ref = {k: [] for k in ("cd", "gd", "rmse_t", "rmse_r", "final")}
    for lo in range(0, len(test_ds), p["batch"]):
        samples = [test_ds[i] for i in range(lo, min(lo + p["batch"], len(test_ds)))]
        nb = collate_fragments(samples, p["max_num_part"], rng=rng)
        pw = np.zeros(nb.pcds.shape[:3], np.float32)
        for i, smp in enumerate(samples):
            if "wall" in smp:
                pw[i, : min(smp["n_parts"], p["max_num_part"])] = smp["wall"][: p["max_num_part"]].astype(np.float32)
        batch = FragmentBatch(*[jnp.asarray(a) for a in nb])
        r = jax.device_get(run(batch))
        mask = nb.node_mask
        for k in ("cd", "gd", "cd_a", "gd_a"):
            got[k].append(r[k][mask])
        for k in ("rmse_t", "rmse_r", "rmse_t_a", "final"):
            got[k].append(np.asarray(r[k]))
        if p["refine_steps"] > 0:
            rr = jax.device_get(refine(batch, jnp.asarray(r["final"][..., :4]), jnp.asarray(r["final"][..., 4:7]),
                                       jnp.asarray(pw) if pw.any() else None))
            for k in ("cd", "gd"):
                ref[k].append(rr[k][mask])
            for k in ("rmse_t", "rmse_r", "final"):
                ref[k].append(np.asarray(rr[k]))
    cat = {k: np.concatenate(v) for k, v in got.items()}

    def acc(cd):
        return {str(t): float((cd < t).mean()) for t in THRESHOLDS_3D}

    metrics = {
        "ratio": ratio,
        "reverse_steps": cfg.steps // ratio,
        "n_parts": int(cat["cd"].size),
        "rmse_t": float(np.mean(cat["rmse_t"].astype(np.float64))),
        "rmse_r": float(np.mean(cat["rmse_r"].astype(np.float64))),
        "gd_r": float(cat["gd"].mean()),
        "part_acc": acc(cat["cd"]),
        "cd_percentiles": {str(q): float(np.percentile(cat["cd"], q)) for q in (5, 10, 25, 50, 75, 90)},
        "gauge_aligned": {"gd_r": float(cat["gd_a"].mean()),
                          "rmse_t": float(np.mean(cat["rmse_t_a"].astype(np.float64))),
                          "part_acc": acc(cat["cd_a"]), "cd_median": float(np.median(cat["cd_a"]))},
    }
    extra = {"final": cat["final"]}
    if p["refine_steps"] > 0:
        rc = {k: np.concatenate(v) for k, v in ref.items()}
        metrics["refined"] = {"steps": p["refine_steps"], "gd_r": float(rc["gd"].mean()),
                              "rmse_t": float(np.mean(rc["rmse_t"].astype(np.float64))),
                              "rmse_r": float(np.mean(rc["rmse_r"].astype(np.float64))),
                              "part_acc": acc(rc["cd"]), "cd_median": float(np.median(rc["cd"]))}
        extra["refined_final"] = rc["final"]
    if out is not None:
        np.savez(out, final=cat["final"], metrics=np.array(json.dumps(metrics)))
    return {**metrics, **extra}


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


def ulp_spread(module, pts: np.ndarray, draws: int = 10) -> tuple[float, float]:
    """(median, max) over ``draws`` draws of one-ulp input noise (each
    coordinate times 1 + {-1, 0, 1}·2⁻²³) of how far ``module``'s output
    moves, over its largest entry."""
    import torch

    with torch.no_grad():
        base = module(torch.tensor(pts))
        moves = []
        for s in range(draws):
            noise = np.random.default_rng(1000 + s).choice([-1, 0, 1], size=pts.shape)
            out = module(torch.tensor(pts * (1 + 2.0**-23 * noise).astype(np.float32)))
            moves.append(float((out - base).abs().max() / base.abs().max()))
    return float(np.median(moves)), max(moves)


def encoder_conditioning() -> dict:
    """For each encoder parity test of ``tests/test_torch_3d_encoders.py``
    whose tolerance is set from it: the port's largest and median error
    against the JAX package's (over the output's largest entry) and its
    one-ulp spread (``ulp_spread``), on the test's own points and weights.

        JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests'); \\
            from torch_assets import encoder_conditioning; print(encoder_conditioning())"
    """
    import jax.numpy as jnp
    import torch

    from diffassemble_tpu.nn.pointnet import PointNet as JPN
    from diffassemble_tpu.nn.vn import VN_DGCNN as JVN
    from diffassemble_tpu.nn.vn import VNPointNetEncoder as JVNP
    from diffassemble_tpu.utils.params import load_params as jload
    from diffassemble_tpu_torch.nn.pointnet import PointNet
    from diffassemble_tpu_torch.nn.vn import VN_DGCNN, VNPointNetEncoder
    from test_torch_3d import _init_shapes, _load, seeded_tree
    from test_torch_3d_encoders import _clouds, _points

    rich, pose = jload(ROOT / "weights" / "vn_dgcnn_rich_rel3d.npz"), jload(ROOT / "weights" / "pointnet_pose3d.npz")
    pts = _points()
    jvnp = JVNP(output_dim=24, n_knn=8)
    cases = {
        "vn_dgcnn_rich_rel3d": (JVN(feat_dim=128, both=True, pool="mean_maxnorm"),
                                VN_DGCNN(feat_dim=128, both=True, pool="mean_maxnorm"), rich["encoder"],
                                _clouds(2, 256, 5, canonical=0.6, wall_detail=0.06, wall_boost=2)),
        "pointnet_pose3d": (JPN(feat_dim=128), PointNet(feat_dim=128), pose["encoder"],
                            _clouds(2, 1000, 6, canonical=0.85)),
        "vnn_seeded": (jvnp, VNPointNetEncoder(output_dim=24, n_knn=8),
                       seeded_tree(_init_shapes(jvnp, jnp.asarray(pts)), 1), pts),
    }
    out = {}
    for name, (jm, tm, params, p) in cases.items():
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(p)))
        _load(tm, params, "encoder")
        with torch.no_grad():
            err = np.abs(tm(torch.tensor(p)).numpy() - want) / np.abs(want).max()
        median, worst = ulp_spread(tm, p)
        out[name] = {"err_max": float(err.max()), "err_median": float(np.median(err)),
                     "ulp_spread_median": median, "ulp_spread_max": worst}
    return out


# ---------------------------------------------------------------------------
# the other trained 2D checkpoints: the mixed-size rot_ms and the discrete
# rot6, each with the held-out protocol that evaluated it

# (step, the protocol's arguments): ``script`` names the JAX script whose
# evaluation it is. diffusion2d_rot_ms: scripts/tpu_train_device.py's run_eval
# as scripts/tpu_queue_r5e.sh:83-88 ran it (the data of its data.json, eval
# images from seed + 1000, calls of 16); diffusion2d_discrete_rot6:
# scripts/tpu_train_variants.py:120-133 and :181-195 (64 images from seed
# 1000, a 60% expander from build_device_data(..., seed=0), calls of 32).
ASSETS_2D = {
    "diffusion2d_rot_ms": (7000, dict(script="tpu_train_device", hw=[6, 8, 10, 12], degree="-1", canonical=0.5,
                                      hf_detail=0.0, style="default", eval_n=64, eval_batch=16, seed=0)),
    "diffusion2d_discrete_rot6": (6000, dict(script="tpu_train_variants", hw=[6], degree="60%", canonical=0.5,
                                             hf_detail=0.0, style="default", eval_n=64, eval_batch=32, seed=0)),
}


def asset_path_2d(name: str) -> Path:
    return ROOT / "diffassemble_tpu_torch" / "assets" / f"{name}_{ASSETS_2D[name][0]}.npz"


def params_2d(name: str) -> dict:
    """The checkpoint's ``eval_params`` (neither run kept an EMA, so its live
    params), restored from a copy so that nothing is written under ``weights/``."""
    import orbax.checkpoint as ocp

    from diffassemble_tpu.train.train_state import TrainState, eval_params

    step = ASSETS_2D[name][0]
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "weights" / name / str(step), Path(tmp) / str(step))
        restored = ocp.StandardCheckpointer().restore(Path(tmp) / str(step) / "default")
    state = TrainState(**restored)
    if state.ema_params is not None:
        raise ValueError(f"weights/{name}/{step} holds an EMA: the protocol evaluated it, export that")
    return eval_params(state)


def heldout_rot_k_2d(protocol: dict) -> np.ndarray:
    """(eval_n, max N) uint8: the rotation draw the JAX gather makes for each
    held-out slice, ``randint(fold_in(PRNGKey(99), lo), (b, n), 0, 4)``
    (unmasked: the mixed gather zeroes padding nodes itself)."""
    import jax

    n = max(protocol["hw"]) ** 2
    total, bs = protocol["eval_n"], protocol["eval_batch"]
    rows = [np.asarray(jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(ROT_SEED), lo),
                                          (min(bs, total - lo), n), 0, 4)) for lo in range(0, total, bs)]
    return np.concatenate(rows).astype(np.uint8)


def protocol_corpus_2d(protocol: dict, eval_n: int | None = None):
    """The protocol's held-out corpus, built by the JAX package (its
    expander's ARPACK start vector fixed, ``fixed_eigsh``)."""
    from diffassemble_tpu.data.datasets import SyntheticImages
    from diffassemble_tpu.train.device_data import build_device_data, build_device_data_mixed

    p = protocol
    n = p["eval_n"] if eval_n is None else eval_n
    kw = dict(n=p["eval_n"], seed=p["seed"] + 1000, cache=False, canonical=p["canonical"],
              hf_detail=p["hf_detail"], style=p["style"])
    sizes = [(s, s) for s in p["hw"]]
    with fixed_eigsh():
        if len(sizes) > 1:
            sources = {}

            def factory(shw, i):
                if shw not in sources:
                    sources[shw] = SyntheticImages(shw, **kw)
                return sources[shw][i]

            return build_device_data_mixed(factory, sizes, n, degree=p["degree"], seed=p["seed"])
        hw = sizes[0]
        return build_device_data(SyntheticImages((hw[0] * 32, hw[1] * 32), **kw), hw, n, degree=p["degree"],
                                 seed=p["seed"])


def jax_model_2d(name: str, compute_dtype: str = "bfloat16"):
    """The JAX package's model of checkpoint ``name`` from its config.json, in ``compute_dtype``."""
    import dataclasses
    import json

    from diffassemble_tpu.models.diffusion_2d import Diffusion2D, Diffusion2DConfig
    from diffassemble_tpu.models.diffusion_2d_discrete import DiscreteDiffusion2DConfig, DiscreteDiffusion2DRot

    base = json.loads((ROOT / "weights" / name / "config.json").read_text())
    if "n_classes" in base:
        cfg = dataclasses.replace(DiscreteDiffusion2DConfig(**base), compute_dtype=compute_dtype, encoder_init="")
        return DiscreteDiffusion2DRot(cfg)
    return Diffusion2D(dataclasses.replace(Diffusion2DConfig(**base), compute_dtype=compute_dtype, encoder_init=""))


def jax_reference_2d(name: str, compute_dtype: str = "bfloat16", eval_n: int | None = None,
                     params: dict | None = None) -> dict:
    """The protocol's metrics (``MeanMetrics.compute()``: overall and per
    size) of checkpoint ``name`` through the JAX package on this host, in
    ``compute_dtype``, on its first ``eval_n`` puzzles (default: all): the
    script's loop, its rotation key per slice and its sample key
    ``fold_in(PRNGKey(7), lo)``. ``rot_ms`` takes about four minutes on a
    CPU in bf16, ``discrete_rot6`` about twenty (its encoder runs at each of
    the 30 steps).

        JAX_PLATFORMS=cpu python -c "from tests.torch_assets import jax_reference_2d; \\
            print(jax_reference_2d('diffusion2d_rot_ms'))"
    """
    import jax
    import jax.numpy as jnp

    from diffassemble_tpu.train.device_data import gather_batch, gather_batch_mixed
    from diffassemble_tpu.train.metrics import MeanMetrics, update_puzzle_metrics

    _, p = ASSETS_2D[name]
    total = eval_n or p["eval_n"]
    model = jax_model_2d(name, compute_dtype)
    params = params_2d(name) if params is None else params
    data = protocol_corpus_2d(p, total)
    gather = gather_batch_mixed if len(p["hw"]) > 1 else gather_batch

    @jax.jit
    def eval_fn(params, batch, key):
        return model.metrics_from_final(model.sample(params, batch, key).final, batch)

    agg = MeanMetrics()
    for lo in range(0, total, p["eval_batch"]):
        idx = jnp.arange(lo, min(lo + p["eval_batch"], total))
        eb = gather(data, idx, jax.random.fold_in(jax.random.PRNGKey(ROT_SEED), lo))
        bm = jax.device_get(eval_fn(params, eb, jax.random.fold_in(jax.random.PRNGKey(7), lo)))
        update_puzzle_metrics(agg, bm, np.asarray(eb.patches_dim), np.asarray(eb.node_mask))
    return {k: float(v) for k, v in agg.compute().items()}


def evaluate_first_batch_2d(name: str, sizes: list[int], calibrate: int = 0, pad: int | None = None,
                            package: str = "jax", compute_dtype: str = "float32") -> list[float]:
    """Per-puzzle piece_acc of checkpoint ``name`` on the first batch of 4
    that ``cli/evaluate.py`` makes (``get_dataset`` synthetic at ``sizes``,
    seed 0, its first sample key), through the pieces of that CLI in
    ``package`` ("jax" or "port") on this host's CPU: OrientationNorm
    statistics calibrated over ``calibrate`` training batches, the puzzles
    padded to ``pad`` nodes (default: the largest size's). Each call takes
    10–50 s.

        JAX_PLATFORMS=cpu python -c "from tests.torch_assets import evaluate_first_batch_2d as f; \\
            print(f('diffusion2d_rot_ms', [6]), f('diffusion2d_rot_ms', [6], pad=144))"
    """
    import jax
    import jax.numpy as jnp

    if package == "jax":
        from diffassemble_tpu.data import PuzzleBatch, collate_puzzles, get_dataset

        model, params = jax_model_2d(name, compute_dtype), params_2d(name)
    else:
        import torch

        from diffassemble_tpu_torch.data import PuzzleBatch, collate_puzzles
        from diffassemble_tpu_torch.data.datasets import get_dataset
        from diffassemble_tpu_torch.train.heldout import load_asset

        model = load_asset(name, "cpu", compute_dtype)[0].eval()
    train_ds, test_ds, _ = get_dataset("synthetic", puzzle_sizes=list(sizes), rotation=True, seed=0)
    calib = []
    for bi in range(calibrate):
        nb = collate_puzzles([train_ds[i % len(train_ds)] for i in range(4 * bi, 4 * bi + 4)], pad or train_ds.max_nodes)
        calib.append((nb.patches.astype(np.float32) / 255.0).reshape(-1, *nb.patches.shape[2:]))
    nb = collate_puzzles([test_ds[i] for i in range(4)], pad or test_ds.max_nodes)
    if package == "jax":
        if calibrate:
            model.calibrate_norm_stats({"encoder": params["encoder"]}, [jnp.asarray(c) for c in calib])
        batch = PuzzleBatch(*[jnp.asarray(a) for a in nb])
        _, key = jax.random.split(jax.random.PRNGKey(0))
        m = model.metrics_from_final(jax.jit(lambda p, b, k: model.sample(p, b, k).final)(params, batch, key), batch)
    else:
        if calibrate:
            model.calibrate_norm_stats(calib)
        batch = PuzzleBatch(*nb).to("cpu")
        with torch.no_grad():
            m = model.metrics_from_final(model.sample(batch, torch.Generator().manual_seed(0)).final, batch)
    return [float(v) for v in np.asarray(m["piece_acc"])]


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 → the bits of its round-to-nearest-even bf16, as uint16 (the
    rounding of ``torch.Tensor.to(torch.bfloat16)`` and ``astype(bfloat16)``)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def export_2d_assets(name: str, out_path=None, reference: dict | None = None) -> Path:
    """Write checkpoint ``name``'s params, its config, its protocol's arguments
    and draws, the step and the JAX package's own CPU bf16 metrics on the
    protocol (``jax_cpu_bfloat16``, JSON; ``reference`` when given, else
    computed: see ``jax_reference_2d``) to ``out_path`` (default: the
    committed asset). Kernels and embedding tables, which the bf16 path
    rounds to bf16 before their first use, are stored as their bf16 bits
    (uint16, listed in ``bfloat16_leaves``; ``convert.load_jax_npz`` widens
    them back to f32, exactly); every other leaf in f32. The draws:
    ``heldout_rot_k`` (``heldout_rot_k_2d``) and, for an expander,
    ``heldout_adj_bits`` (``np.packbits`` of the (N, N) topology).

        JAX_PLATFORMS=cpu python -c "from tests.torch_assets import export_2d_assets; \\
            export_2d_assets('diffusion2d_discrete_rot6')"
    """
    import json

    import jax
    from flax.traverse_util import flatten_dict

    step, protocol = ASSETS_2D[name]
    params = params_2d(name)
    if reference is None:
        reference = jax_reference_2d(name, "bfloat16", params=params)
    arrays, bf16 = {}, []
    for k, v in flatten_dict(params).items():
        key = "/".join(k)
        if k[-1] in ("kernel", "embedding"):
            arrays[key] = bf16_bits(np.asarray(v))
            bf16.append(key)
        else:
            arrays[key] = np.asarray(v, dtype=np.float32)
    arrays.update(
        bfloat16_leaves=np.array(bf16),
        config=np.array(json.dumps(json.loads((ROOT / "weights" / name / "config.json").read_text()),
                                   sort_keys=True)),
        protocol=np.array(json.dumps(protocol, sort_keys=True)),
        heldout_rot_k=heldout_rot_k_2d(protocol),
        jax_cpu_bfloat16=np.array(json.dumps(reference, sort_keys=True)),
        jax_version=np.array(jax.__version__),
        jax_threefry_partitionable=np.array(bool(jax.config.jax_threefry_partitionable)),
        step=np.array(step, dtype=np.int64),
    )
    if protocol["degree"] not in (-1, "-1"):
        arrays["heldout_adj_bits"] = np.packbits(np.asarray(protocol_corpus_2d(protocol, 0).adj))
    out_path = Path(out_path or asset_path_2d(name))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **arrays)
    return out_path
