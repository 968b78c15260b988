"""The port's 3D model against the JAX package's, on the CPU: one
``ddim_step_se3``, a 3-step ``sample`` of a small ``Diffusion3D`` with
converted seeded weights, the converter's coverage of the 3D tree, the
held-out protocol's metrics (``train/heldout3d.py``) against
``scripts/tpu_eval_3d.py``'s formulas, the committed trained checkpoint on
two objects, and ``cli/train_3d.py``'s ``run_3d --evaluate`` against the JAX
``Trainer.evaluate``.

Tolerances (f32): a DDIM step 1e-5 (a handful of f32 roundings through
so3_scale); sampled poses of the small model from the same features 1e-4,
of the trained one from its own
2e-3 (measured 7.3e-4: 30 steps through a VN encoder whose norm
standardization amplifies rounding); metrics of the same poses 1e-5
relative, part accuracies exactly; the metrics of sampled poses as the poses
allow (rmse_t 1e-4, rmse_r 0.1°, gd_r 1e-3)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.data.batch import FragmentBatch as JFragmentBatch
from diffassemble_tpu.models import losses_3d as jl3
from diffassemble_tpu.models.diffusion_3d import Diffusion3D as JDiffusion3D
from diffassemble_tpu.models.diffusion_3d import Diffusion3DConfig as JConfig
from diffassemble_tpu.ops import so3 as jso3
from diffassemble_tpu.ops.knn import chamfer_distance as jchamfer
from diffassemble_tpu.train import metrics as jmetrics
from diffassemble_tpu.train import trainer as jtrainer
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.cli import train_3d
from diffassemble_tpu_torch.data import breaking_bad as tbb
from diffassemble_tpu_torch.models import Diffusion3D, Diffusion3DConfig
from diffassemble_tpu_torch.train import heldout3d, metrics as tmetrics, trainer as ttrainer
from diffassemble_tpu_torch.train.checkpoint import CheckpointManager
from diffassemble_tpu_torch.train.train_state import TrainState
from diffassemble_tpu_torch.utils.params import load_params
from test_torch_3d import seeded_tree
from torch_assets import ASSET_3D, PROTOCOL_3D, export_3d_assets, protocol_dataset_3d

SMALL = dict(steps=30, inference_ratio=10, backbone="vn_dgcnn_rich", n_layers=2, hidden_dim=16, heads=2,
             max_num_part=4, rel_condition=True, rel_pose_weight=0.5, rel_k=4, compute_dtype="float32")
DATA = dict(num_points=32, min_num_part=2, max_num_part=4, train_n=2, test_n=4, seed=3, canonical=0.9,
            wall_detail=0.08, wall_boost=3)


def _batch(n=2):
    _, test_ds, _ = tbb.get_dataset_3d("synthetic", **DATA)
    return tbb.collate_fragments([test_ds[i] for i in range(n)], SMALL["max_num_part"],
                                 rng=np.random.default_rng(0))


def _small_models(seed=0, **overrides):
    """(JAX model, its seeded params, port model with them converted)."""
    cfg = {**SMALL, **overrides}
    jm = JDiffusion3D(JConfig(**cfg))
    nb = _batch()
    shapes = jax.eval_shape(lambda k: jm.init(k, JFragmentBatch(*[jnp.asarray(a) for a in nb])),
                            jax.random.PRNGKey(0))
    params = seeded_tree(shapes, seed)
    tm = Diffusion3D(Diffusion3DConfig(**cfg), device="cpu")
    tm.load_state_dict(convert.convert_params(jax.tree.map(np.asarray, params), convert.HEADS_3D),
                       strict=True)
    return jm, params, tm


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
                               rtol=0, atol=atol)


def test_converter_uses_every_leaf_of_the_3d_tree_once():
    jm, params, tm = _small_models()
    leaves = jax.tree_util.tree_leaves_with_path(params)
    state = convert.convert_params(jax.tree.map(np.asarray, params), convert.HEADS_3D)
    own = tm.state_dict()
    assert len(state) == len(leaves) == len(own) and state.keys() == own.keys()
    assert set(params) == {"encoder", "relpose", "denoiser"}
    for path, leaf in leaves:
        keys = [getattr(k, "key", None) for k in path]
        assert np.prod(leaf.shape) in {v.numel() for v in state.values()}, keys
    # raw projections and VN channel mixes keep their values
    assert np.array_equal(state["rel_head.U"].numpy(), np.asarray(params["relpose"]["U"]))
    vn = params["encoder"]["VNLinearLeakyReLU_0"]["map_to_feat"]["kernel"]
    assert np.array_equal(state["encoder.layers.0.map_to_feat.weight"].numpy(), np.asarray(vn).T)
    assert np.array_equal(state["encoder.layers.0.norm.weight"].numpy(),
                          np.asarray(params["encoder"]["VNLinearLeakyReLU_0"]["VNNorm_0"]["scale"]))
    # the caller names the denoiser's heads; a count that does not fit them raises
    assert {k.split(".")[1] for k in state if k.startswith("denoiser.mlp_")} == {"mlp_t", "mlp_r"}
    with pytest.raises(ValueError, match="heads"):
        convert.convert_params({"denoiser": params["denoiser"]}, ("pos_mlp", "final"))


# the other backbones' models: no pairwise head; vn_dgcnn with split message passing
OTHER_TREES = {
    "pointnet": dict(backbone="pointnet"),
    "pointnet_inv": dict(backbone="pointnet_inv"),
    "pointnet_plus": dict(backbone="pointnet_plus"),
    "vnn": dict(backbone="vnn"),
    "vn_dgcnn_equiv_inv_mp": dict(backbone="vn_dgcnn", equiv_inv_mp=True),
}


@pytest.mark.parametrize("name", sorted(OTHER_TREES))
def test_converter_uses_every_leaf_of_the_other_3d_trees_once(name):
    """The PointNet, PointNet-T-net, PointNet++ and VN-PointNet encoders'
    trees and the dual-stream denoiser's (``layer_i/conv/...``): every leaf
    of the JAX tree becomes one entry of the port's state_dict, of its
    size, and the port has no other."""
    jm, params, tm = _small_models(**OTHER_TREES[name], rel_condition=False, rel_pose_weight=0.0)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    state = convert.convert_params(jax.tree.map(np.asarray, params), convert.HEADS_3D)
    own = tm.state_dict()
    assert len(state) == len(leaves) == len(own) and state.keys() == own.keys()
    assert sorted(np.prod(leaf.shape) for _, leaf in leaves) == sorted(v.numel() for v in state.values())
    assert set(params) == {"encoder", "denoiser"}
    if name == "vn_dgcnn_equiv_inv_mp":
        assert any(".conv." in k for k in state) and "DualStreamGraphTransformer_0" in params["denoiser"]
    if name == "pointnet_inv":  # the T-nets' last layer: a Dense kernel (256, k²) becomes (k², 256)
        kernel = params["encoder"]["TNet_1"]["Dense_2"]["kernel"]
        assert np.array_equal(state["encoder.tnets.1.dense.2.weight"].numpy(), np.asarray(kernel).T)


def test_ddim_step_se3_matches():
    jm, _, tm = _small_models()
    rng = np.random.default_rng(1)
    b, p = 2, 4

    def poses():
        q = rng.standard_normal((b, p, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        return np.concatenate([q, 0.3 * rng.standard_normal((b, p, 3)).astype(np.float32)], -1)

    x, out = poses(), poses()
    t = np.array([[29, 29, 15, 15], [5, 5, 0, 0]], dtype=np.int32)  # t - ratio < 0 in the second
    want = jm.ddim_step_se3(jnp.asarray(x), jnp.asarray(t), jnp.asarray(out), 10)
    got = tm.ddim_step_se3(torch.tensor(x), torch.tensor(t), torch.tensor(out), 10)
    _close(got, want, 1e-5)


def test_small_model_samples_three_steps_as_the_jax_package(monkeypatch):
    """The sampler from the same point features: the pairwise head, the
    consensus at each step, the denoiser and the SE(3) DDIM updates (the
    encoder is held to the JAX package's in tests/test_torch_3d.py; its
    seeded weights amplify f32 rounding to 5e-4 of the features, which 30
    steps would carry into the poses)."""
    jm, params, tm = _small_models()
    nb = _batch()
    jb = JFragmentBatch(*[jnp.asarray(a) for a in nb])
    want, want_traj = jax.jit(lambda p, b: jm.sample(p, b, jax.random.PRNGKey(0), keep_trajectory=True))(params, jb)
    feats = torch.tensor(np.asarray(jm.pcd_features(params, jb.pcds)))
    monkeypatch.setattr(tm, "pcd_features", lambda pcds: feats)
    res = tm.sample(nb.to("cpu"), keep_trajectory=True)
    assert res.final.shape == (2, 4, 7) and res.trajectory.shape == (3, 2, 4, 7)
    v = nb.node_mask
    _close(res.final.numpy()[v], np.asarray(want)[v], 1e-4)
    _close(res.trajectory.numpy()[:, v], np.asarray(want_traj)[:, v], 1e-4)
    got_m = tm.metrics_from_final(res.final, nb.to("cpu"))
    want_m = jm.metrics_from_final(want, jb)
    for key in ("rmse_t", "rmse_r", "gd_r", "part_acc"):
        _close(got_m[key], want_m[key], {"rmse_r": 0.1, "gd_r": 1e-3}.get(key, 1e-4))


def test_training_entry_points_raise_naming_the_roadmap_item():
    """Nothing of the 3D model names a ROADMAP item any more: split
    equivariant/invariant message passing builds, on the VN encoders alone,
    as in the JAX package; DDPM sampling raises as the JAX package's does."""
    model = Diffusion3D(Diffusion3DConfig(**{**SMALL, "equiv_inv_mp": True}), device="cpu")
    assert model.denoiser.equiv_inv_mp and model.denoiser.equiv_dim == model.equiv_dim == 1536
    with pytest.raises(ValueError, match="vn_dgcnn"):
        Diffusion3D(Diffusion3DConfig(**{**SMALL, "equiv_inv_mp": True, "backbone": "vnn", "rel_condition": False,
                                         "rel_pose_weight": 0.0}), device="cpu")
    with pytest.raises(ValueError, match="DDIM"):
        Diffusion3D(Diffusion3DConfig(**{**SMALL, "sampling": "ddpm"}), device="cpu")


def test_heldout3d_metrics_are_the_scripts(monkeypatch):
    """Given the same sampled poses, ``heldout3d_eval`` reports what
    ``scripts/tpu_eval_3d.py``'s formulas give (per-part CD through the JAX
    package's transform and Chamfer, rmse per object, gd per part)."""
    _, test_ds, _ = tbb.get_dataset_3d("synthetic", **{**DATA, "test_n": 5})
    tm = Diffusion3D(Diffusion3DConfig(**SMALL), device="cpu")
    rng = np.random.default_rng(4)
    finals = []

    def fake_sample(batch, generator=None, inference_ratio=None):
        gt = batch.x0.numpy()
        q = gt[..., :4] + 0.1 * rng.standard_normal(gt[..., :4].shape).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        t = gt[..., 4:7] + 0.03 * rng.standard_normal(gt[..., 4:7].shape).astype(np.float32)
        final = np.concatenate([q, t], -1)
        finals.append(final)
        return type("R", (), {"final": torch.tensor(final)})

    monkeypatch.setattr(tm, "sample", fake_sample)
    got = heldout3d.heldout3d_eval(tm, test_ds, batch=2, max_num_part=4, seed=0)

    rng_c = np.random.default_rng(0)
    cds, gds, rts, rrs = [], [], [], []
    for bi, lo in enumerate(range(0, len(test_ds), 2)):
        nb = tbb.collate_fragments([test_ds[i] for i in range(lo, min(lo + 2, len(test_ds)))], 4, rng=rng_c)
        final = jnp.asarray(finals[bi])
        pred_q, pred_t = final[..., :4], final[..., 4:7]
        gt_q, gt_t = jnp.asarray(nb.x0[..., :4]), jnp.asarray(nb.x0[..., 4:7])
        pts, v = jnp.asarray(nb.pcds), jnp.asarray(nb.node_mask)
        d1, d2 = jchamfer(jl3.transform_pc(pred_t, pred_q, pts), jl3.transform_pc(gt_t, gt_q, pts))
        cd = np.asarray(jnp.mean(d1, axis=-1) + jnp.mean(d2, axis=-1))
        gd = np.asarray(jso3.geodesic_distance_rmat(jso3.quaternion_to_matrix(pred_q),
                                                    jso3.quaternion_to_matrix(gt_q)))
        cds.append(cd[nb.node_mask])
        gds.append(gd[nb.node_mask])
        rts.append(np.asarray(jl3.trans_rmse(pred_t, gt_t, v)))
        rrs.append(np.asarray(jl3.rot_euler_rmse(pred_q, gt_q, v)))
    cd, gd = np.concatenate(cds), np.concatenate(gds)
    assert got["n_parts"] == cd.size == sum(int(s["n_parts"]) for s in (test_ds[i] for i in range(5)))
    _close(got["rmse_t"], np.mean(np.concatenate(rts).astype(np.float64)), 1e-6)
    _close(got["rmse_r"], np.mean(np.concatenate(rrs).astype(np.float64)), 1e-4)
    _close(got["gd_r"], gd.mean(), 1e-6)
    for t in heldout3d.THRESHOLDS:
        assert got["part_acc"][str(t)] == float((cd < t).mean())
    for q in heldout3d.PERCENTILES:
        _close(got["cd_percentiles"][str(q)], np.percentile(cd, q), 1e-5 * max(cd.max(), 1e-6))
    assert 0 < got["part_acc"]["0.05"] < 1 or 0 < got["part_acc"]["0.2"] < 1


def test_protocol_corpus_is_the_scripts():
    p = PROTOCOL_3D
    want = protocol_dataset_3d(3)
    got = heldout3d.protocol_dataset(test_n=3, num_points=p["num_points"], max_num_part=p["max_num_part"],
                                     min_num_part=p["min_num_part"], wall_detail=p["wall_detail"],
                                     wall_boost=p["wall_boost"], canonical=p["canonical"], seed=p["seed"])
    for i in range(3):
        a, b = want[i], got[i]
        assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


# ------------------------------------------------ the committed trained checkpoint


def test_export_rebuilds_the_committed_3d_asset(tmp_path):
    rebuilt = export_3d_assets(tmp_path / "assets3d.npz")
    with np.load(ASSET_3D) as want, np.load(rebuilt) as got:
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            a, b = want[key], got[key]
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key


def test_the_trained_checkpoint_loads_strictly_and_carries_its_protocol():
    model, cfg, protocol, step = heldout3d.model_from_asset(device="cpu")
    assert step == 12000 and protocol == PROTOCOL_3D
    assert cfg.backbone == "vn_dgcnn_rich" and cfg.rel_condition and cfg.compute_dtype == "bfloat16"
    assert sum(v.numel() for v in model.state_dict().values()) == 7_444_184


def test_trained_checkpoint_on_two_objects_matches_the_jax_package():
    """Both packages in f32 on the protocol's first two objects: the same
    poses and metrics."""
    tree = load_params(ASSET_3D)
    cfg = {**json.loads(str(tree.pop("config"))), "compute_dtype": "float32", "encoder_init": ""}
    params = jax.tree.map(jnp.asarray, {k: v for k, v in tree.items() if isinstance(v, dict)})
    model, _, protocol, _ = heldout3d.model_from_asset(device="cpu", compute_dtype="float32")
    jm = JDiffusion3D(JConfig(**cfg))
    ds = protocol_dataset_3d(2)
    nb = tbb.collate_fragments([ds[0], ds[1]], protocol["max_num_part"], rng=np.random.default_rng(0))
    jb = JFragmentBatch(*[jnp.asarray(a) for a in nb])
    want = np.asarray(jax.jit(lambda b: jm.sample(params, b, jax.random.PRNGKey(7))[0])(jb))
    got = model.sample(nb.to("cpu")).final
    v = nb.node_mask
    _close(got.numpy()[v], want[v], 2e-3)
    got_m = model.metrics_from_final(got, nb.to("cpu"))
    want_m = jm.metrics_from_final(jnp.asarray(want), jb)
    for key, tol in (("rmse_t", 1e-4), ("rmse_r", 0.1), ("gd_r", 1e-3)):
        _close(got_m[key], want_m[key], tol)
    assert np.array_equal(got_m["part_acc"].numpy(), np.asarray(want_m["part_acc"]))


# ------------------------------------------------------------- the CLI


def _args(run_dir, *extra):
    ap = train_3d.argparse.ArgumentParser()
    train_3d.add_3d_args(ap)
    return ap.parse_args([
        "--dataset", "synthetic", "--run_dir", str(run_dir), "--num_points", "32", "--max_num_part", "4",
        "--test_n", "4", "--batch_size", "2", "--synthetic_canonical", "0.9", "--wall_detail", "0.08",
        "--wall_boost", "3", "--seed", "3", "--device", "cpu", *extra])


def _port_run(tmp_path, params, ema=None):
    """A run of the port holding the small model's converted params as step 7
    (with ``ema``, an EMA of other params beside them)."""
    tm = Diffusion3D(Diffusion3DConfig(**SMALL), device="cpu")
    state = convert.convert_params(jax.tree.map(np.asarray, params), convert.HEADS_3D)
    tm.load_state_dict(state, strict=True)
    run = tmp_path / "run"
    ckpt = CheckpointManager(run / "checkpoints", monitor="rmse_t_AVG", mode="min")
    ckpt.save_config(tm.cfg)
    ckpt.save(7, TrainState(dict(tm.named_parameters()), {}, 7, torch.Generator().manual_seed(0), ema))
    return run, tm


def test_run_3d_evaluates_a_port_run_as_the_jax_trainer(tmp_path):
    jm, params, _ = _small_models(seed=5)
    run, _ = _port_run(tmp_path, params)
    got = train_3d.run_3d(_args(run, "--evaluate", "true", "--num_iter", "2"))

    _, test_ds, cats = tbb.get_dataset_3d("synthetic", **DATA)
    jt = jtrainer.Trainer(jm, run_dir=str(tmp_path / "jax"), batch_size=2, seed=3, viz_every_eval=0,
                          adapter=jtrainer.fragment_adapter(4, cats, seed=3))
    want = jt.evaluate(params, test_ds, tag="test")
    assert set(got) == set(want) and "rmse_t_AVG" in got
    for key, (mean, std) in got.items():
        assert std == 0.0  # the sampler draws nothing: both iterations agree
        tol = 0.1 if key.startswith("rmse_r") else 1e-3 if key.startswith("gd_r") else 1e-4
        _close(mean, want[key], tol)


def test_run_3d_takes_the_ema_of_the_latest_checkpoint_or_an_explicit_checkpoints_live_params(tmp_path):
    _, params, _ = _small_models(seed=6)
    _, other, _ = _small_models(seed=7)
    ema = convert.convert_params(jax.tree.map(np.asarray, other), convert.HEADS_3D)
    run, _ = _port_run(tmp_path, params, ema=ema)
    latest = train_3d.run_3d(_args(run, "--evaluate", "true"))
    explicit = train_3d.run_3d(_args(run, "--evaluate", "true", "--checkpoint_path", str(run)))

    _, test_ds, _ = tbb.get_dataset_3d("synthetic", **DATA)
    live = convert.convert_params(jax.tree.map(np.asarray, params), convert.HEADS_3D)
    for state, result in ((ema, latest), (live, explicit)):
        model = Diffusion3D(Diffusion3DConfig(**SMALL), device="cpu")
        model.load_state_dict(state, strict=True)
        rts = []
        for lo in (0, 2):
            nb = tbb.collate_fragments([test_ds[lo], test_ds[lo + 1]], 4).to("cpu")
            rts.append(model.evaluate(nb)["rmse_t"].numpy())
        _close(result["rmse_t_AVG"][0], np.concatenate(rts).mean(), 1e-6)
    assert latest["rmse_t_AVG"][0] != explicit["rmse_t_AVG"][0]


def test_run_3d_refuses_training_and_mesh_export(tmp_path, capsys):
    """Nothing is refused any more. ``--gpus 2`` in a single process trains
    on its one device and says so (several processes: the 3D dryrun,
    ``tests/test_torch_3d_parallel.py``); ``--evaluate true --export_meshes``
    writes each of the first 4 held-out objects' trajectory (a ``.ply`` a
    step and the ``_traj.npz``), whose last step is, bit for bit, the
    model's own sample; as in the JAX CLI, the flag without ``--evaluate``
    trains and exports nothing."""
    train_3d.run_3d(_args(tmp_path / "gpus", "--gpus", "2", "--export_meshes", "--max_steps", "1", "--n_layers",
                          "1", "--train_n", "2", "--test_n", "2"))
    assert "--gpus 2: this run has 1 process(es)" in capsys.readouterr().out
    assert (tmp_path / "gpus" / "checkpoints" / "1" / "state.pt").is_file()
    assert not (tmp_path / "gpus" / "meshes").exists()

    _, params, _ = _small_models(seed=5)
    run, tm = _port_run(tmp_path, params)
    train_3d.run_3d(_args(run, "--evaluate", "true", "--export_meshes"))
    meshes = run / "meshes"
    assert sorted(p.name for p in meshes.iterdir()) == sorted(
        [f"obj{b}_traj.npz" for b in range(4)] + [f"obj{b}_step{s:03d}.ply" for b in range(4) for s in range(3)])
    _, test_ds, _ = tbb.get_dataset_3d("synthetic", **DATA)
    nb = tbb.collate_fragments([test_ds[i] for i in range(4)], SMALL["max_num_part"])
    final = tm.sample(nb.to("cpu"), torch.Generator().manual_seed(1)).final.numpy()
    for b in range(4):
        with np.load(meshes / f"obj{b}_traj.npz") as z:
            assert z["trajectory"].shape == (3, 4, 7) and np.array_equal(z["trajectory"][-1], final[b])
            assert np.array_equal(z["pcds"], nb.pcds[b]) and np.array_equal(z["valids"], nb.node_mask[b])


def test_fragment_adapter_and_metrics_match_the_jax_trainer():
    _, test_ds, cats = tbb.get_dataset_3d("synthetic", **{**DATA, "min_num_part": 3})
    samples = [test_ds[i] for i in range(4)]
    a = jtrainer.fragment_adapter(4, cats, missing_perc=40, seed=2)
    b = ttrainer.fragment_adapter(4, cats, missing_perc=40, seed=2)
    for _ in range(2):  # the adapter's one rng, drawn from in turn
        for x, y in zip(a.collate(samples, 4), b.collate(samples, 4)):
            assert np.array_equal(x, y)
    bm = {k: np.random.default_rng(i).random(4).astype(np.float32)
          for i, k in enumerate(("rmse_t", "rmse_r", "gd_r", "part_acc"))}
    cat_ids = np.array([0, 1, 1, 7])
    ja, ta = jmetrics.MeanMetrics(), tmetrics.MeanMetrics()
    jmetrics.update_fragment_metrics(ja, bm, cat_ids, cats)
    tmetrics.update_fragment_metrics(ta, bm, cat_ids, cats)
    assert ja.compute() == ta.compute()


def test_the_3d_config_loads_the_checkpoints_config_json():
    from torch_assets import CHECKPOINT_3D

    saved = json.loads((CHECKPOINT_3D / "config.json").read_text())
    assert dataclasses.asdict(Diffusion3DConfig(**saved)) == saved
    assert {f.name for f in dataclasses.fields(Diffusion3DConfig)} == {f.name for f in dataclasses.fields(JConfig)}
