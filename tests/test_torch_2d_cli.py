"""The equivariant and discrete 2D family through the port's entry points on
the CPU, tiny: ``train_2d_rot --discrete true --backbone resnet18equiv``
(train, checkpoint, resume, ``--evaluate``), ``train_device --backbone
resnet18equiv`` on a mixed corpus (train, resume) and ``--evaluate_npz`` on a
JAX-written parameter npz, the trainer's eval-time calibration (restored
after, skipped on failure), and ``serve --run_dir`` with a ``norm_stats.npz``
written by the JAX package; then the equivariant recipe's data-parallel step
on two gloo ranks against one process on the whole batch
(``parallel/dryrun.py``, its tolerances).
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.nn import visual as jv
from diffassemble_tpu_torch.cli import common, serve, train_2d_rot, train_device
from diffassemble_tpu_torch.nn import visual as tv
from diffassemble_tpu_torch.train import checkpoint
from test_torch_3d import seeded_tree
from torch_parity import seeded_params

TINY = ["-dataset", "synthetic", "-puzzle_sizes", "2", "-steps", "20", "-batch_size", "2", "--n_layers", "1",
        "--compute_dtype", "float32", "--aux_loss_weight", "0.1", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _First:
    """The first ``n`` samples of a dataset."""

    def __init__(self, ds, n: int):
        self.ds, self.n, self.max_nodes = ds, n, ds.max_nodes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


def _run_rot_cli(monkeypatch, *flags):
    """The rotation CLI in this process, its held-out set cut to 4 puzzles."""
    build = common.build_2d_datasets

    def small(args):
        train, test, sizes = build(args)
        return train, _First(test, 4), sizes

    monkeypatch.setattr(common, "build_2d_datasets", small)
    monkeypatch.setattr(sys, "argv", ["train_2d_rot", *flags])
    train_2d_rot.main()


def test_discrete_rotation_cli_trains_resumes_and_evaluates(tmp_path, monkeypatch, capsys):
    """K = 4 cells of a 2×2 puzzle, cold diffusion, the hybrid loss: two steps,
    a resume to three, then ``--evaluate`` of the latest checkpoint."""
    flags = [*TINY, "--discrete", "true", "--cold_diffusion", "true", "--loss_type", "hybrid",
             "--backbone", "resnet18equiv", "--run_dir", str(tmp_path / "run")]
    _run_rot_cli(monkeypatch, *flags, "-max_steps", "2")
    _run_rot_cli(monkeypatch, *flags, "-max_steps", "3")
    ckpt = tmp_path / "run" / "checkpoints"
    cfg = json.loads((ckpt / "config.json").read_text())
    assert cfg["n_classes"] == 4 and cfg["discrete_loss"] == "hybrid" and cfg["cold_diffusion"]
    assert sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())[-1] == 3
    recs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in recs if "rot_loss" in r]
    assert [r["step"] for r in losses] == [1] and np.isfinite(losses[0]["total_loss"])  # the trainer logs step 1
    assert "resumed from step 2" in capsys.readouterr().out
    _run_rot_cli(monkeypatch, *flags, "--evaluate", "true")
    assert "overall_acc" in capsys.readouterr().out.splitlines()[-1]


def test_recipe_cli_trains_the_equivariant_encoder_on_a_mixed_corpus(tmp_path, monkeypatch):
    """``cli/train_device.py`` with its default backbone (resnet18equiv) on
    2×2 and 3×3 puzzles: two steps with an evaluation, a resume to three."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DIFFASSEMBLE_DEADLINE_EPOCH", str(time.time() + 86400))
    flags = ["--run_dir", "run", "--hw", "2", "3", "--degree", "-1", "--n_layers", "1", "--steps", "20",
             "--batch_size", "2", "--train_n", "4", "--eval_n", "2", "--eval_every", "2", "--log_every", "1",
             "--compute_dtype", "float32", "--aux_loss_weight", "0.1", "--viz_every_eval", "0", "--device", "cpu"]
    assert train_device.build_parser().parse_args(["--run_dir", "x"]).backbone == "resnet18equiv"
    m = train_device.main(flags + ["--max_steps", "2"])
    assert m["overall_nImages"] == 2 and {"(2, 2)_nImages", "(3, 3)_nImages"} <= set(m)
    train_device.main(flags + ["--max_steps", "3"])
    recs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["grad_norm/encoder"] > 0 for r in steps)


def test_recipe_cli_evaluates_a_jax_parameter_npz(tmp_path, monkeypatch):
    """``--evaluate_npz``: the JAX package's tree of the recipe's model (its
    own init, written flat), with a rotation draw, evaluated once and nothing
    written to the run; the same metrics as ``heldout_eval`` of the loaded
    model on the corpus the CLI trains against, with the same draw and
    sampler seed."""
    from diffassemble_tpu.data.batch import PuzzleBatch as JBatch
    from diffassemble_tpu.models.diffusion_2d import Diffusion2D as JD
    from diffassemble_tpu.models.diffusion_2d import Diffusion2DConfig as JC
    from diffassemble_tpu_torch import convert
    from diffassemble_tpu_torch.train.heldout import SAMPLE_SEED, heldout_eval

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DIFFASSEMBLE_DEADLINE_EPOCH", str(time.time() + 86400))
    cfg = dict(steps=20, mean_type="xstart", rotation=True, backbone="resnet18equiv", architecture="exophormer",
               n_layers=1, virt_nodes=8, aux_loss_weight=0.1)
    jm = JD(JC(**cfg))
    dummy = JBatch(patches=jnp.zeros((1, 4, 32, 32, 3)), x0=jnp.zeros((1, 4, 4)), grid=jnp.zeros((1, 4, 2)),
                   adj=jnp.ones((1, 4, 4), bool), node_mask=jnp.ones((1, 4), bool),
                   patches_dim=jnp.array([[2, 2]]), index=jnp.zeros((1,), jnp.int32))
    tree = _flat(seeded_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(3), dummy), 3))
    rot_k = np.random.default_rng(4).integers(0, 4, (2, 4)).astype(np.uint8)
    np.savez(tmp_path / "params.npz", **tree, heldout_rot_k=rot_k)
    flags = ["--run_dir", "run", "--hw", "2", "--degree", "-1", "--n_layers", "1", "--steps", "20",
             "--batch_size", "2", "--train_n", "2", "--eval_n", "2", "--compute_dtype", "float32",
             "--aux_loss_weight", "0.1", "--viz_every_eval", "0", "--device", "cpu",
             "--evaluate_npz", str(tmp_path / "params.npz")]
    m = train_device.main(flags)
    assert not (tmp_path / "run").exists() and not (tmp_path / "runs").exists()
    from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig

    model = Diffusion2D(Diffusion2DConfig(**cfg, inference_ratio=10, sampling="ddim"), device="cpu")
    model.load_state_dict(convert.load_jax_npz(tmp_path / "params.npz")[0], strict=True)
    args = train_device.build_parser().parse_args(flags)
    topo = train_device.size_topologies([(2, 2)], "-1", 0)
    data = train_device.load_corpus(args, "eval", 2, 1000, topo, torch.device("cpu"))
    want = heldout_eval(model, data, torch.as_tensor(rot_k.astype(np.int64)), eval_n=2,
                        generator=torch.Generator().manual_seed(SAMPLE_SEED))
    assert m == want


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _trainer(tmp_path, backbone="resnet18equiv"):
    from diffassemble_tpu_torch.train.trainer import Trainer

    ap = argparse.ArgumentParser()
    common.add_2d_args(ap)
    args = ap.parse_args([*TINY, "--backbone", backbone, "--rotation", "true"])
    model = common.build_2d_model(args)
    _, test_ds, _ = common.build_2d_datasets(args)
    return Trainer(model, run_dir=str(tmp_path / "t"), batch_size=2, calibrate_batches=2), test_ds


def test_evaluation_calibrates_and_restores_the_statistics(tmp_path):
    """With ``calibrate_eval`` every OrientationNorm runs frozen on the
    statistics of the first batches during the evaluation, and the model's
    own (none) come back after; a failing calibration is skipped."""
    tr, test_ds = _trainer(tmp_path)
    model = tr.model
    seen = []
    sample = model.sample

    def spy(batch, generator=None, **kw):
        seen.append([m.frozen_mean is not None for _, m in tv.norm_layers(model.encoder)])
        return sample(batch, generator, **kw)

    model.sample = spy
    params = dict(model.named_parameters())
    tr.evaluate(params, test_ds, max_batches=1)
    assert seen and all(all(s) for s in seen)
    assert model.norm_stats is None and all(m.frozen_mean is None for _, m in tv.norm_layers(model.encoder))
    seen.clear()
    tr.calibrate_eval = False
    tr.evaluate(params, test_ds, max_batches=1)
    assert seen and not any(any(s) for s in seen)
    tr.calibrate_eval = True
    model.calibrate_norm_stats = lambda batches: 1 / 0
    m = tr.evaluate(params, test_ds, max_batches=1)  # calibration fails: the evaluation goes on
    assert "overall_acc" in m and model.norm_stats is None


def test_serve_loads_a_norm_stats_npz_of_the_jax_package(tmp_path):
    """A run of the port's trainer (one checkpoint of the JAX package's
    seeded encoder weights, converted) with a ``norm_stats.npz`` that the
    JAX package's ``calibrate_norm_stats`` and ``save_norm_stats`` wrote for
    that encoder: ``PuzzleSolver.from_run`` serves with those statistics
    frozen, the features equal the JAX package's frozen ones (1e-4 of the
    largest entry) and those of the statistics set by hand; without the file
    it serves with batch statistics."""
    from diffassemble_tpu_torch import convert
    from diffassemble_tpu_torch.train.train_state import create_train_state

    run = tmp_path / "run"
    tr, _ = _trainer(tmp_path)
    model = tr.model
    jm = jv.EquivariantResNet18()
    x = np.random.default_rng(0).random((6, 32, 32, 3)).astype(np.float32)
    enc = seeded_params(jm, 1, jnp.asarray(x))
    state = convert.convert_params({"encoder": enc})
    model.encoder.load_state_dict({k[len("encoder."):]: v for k, v in state.items()}, strict=True)
    mgr = checkpoint.CheckpointManager(run / "checkpoints")
    mgr.save_config(model.cfg)
    mgr.save(1, create_train_state(model, model.make_optimizer(), torch.Generator()))
    plain = serve.PuzzleSolver.from_run(run, puzzle_size=2, device="cpu")
    assert plain.model.norm_stats is None
    stats = jv.calibrate_norm_stats(jm, enc, [jnp.asarray(x)])
    jv.save_norm_stats(run / "norm_stats.npz", stats)
    solver = serve.PuzzleSolver.from_run(run, puzzle_size=2, device="cpu")
    flat = tv._flat(jax.device_get(stats))
    for path, m in tv.norm_layers(solver.model.encoder):
        assert np.array_equal(m.frozen_mean.numpy(), np.asarray(flat[f"{path}/mean"]).reshape(-1))
        assert np.array_equal(m.frozen_var.numpy(), np.asarray(flat[f"{path}/var"]).reshape(-1))
    img = np.random.default_rng(2).random((64, 64, 3)).astype(np.float32)
    patches, final = solver.predict_positions(img)
    assert final.shape == (4, 4) and np.isfinite(final).all()
    pieces = patches[:2].astype(np.float32) / (255.0 if patches.dtype == np.uint8 else 1.0)
    with torch.no_grad():
        frozen = solver.model.encoder(torch.tensor(pieces))
        tv.set_norm_stats(plain.model.encoder, tv.load_norm_stats(run / "norm_stats.npz"))
        by_hand = plain.model.encoder(torch.tensor(pieces))
    assert torch.isfinite(frozen).all() and torch.equal(frozen, by_hand)
    want = np.asarray(jm.apply({"params": enc, "norm_stats": stats}, jnp.asarray(pieces)))
    assert np.abs(frozen.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_equivariant_recipe_step_on_two_gloo_ranks():
    """``parallel/dryrun.py`` with resnet18equiv: OrientationNorm's statistics
    and the masked means span both ranks, equal and unequal valid nodes."""
    from diffassemble_tpu_torch.parallel.dryrun import dryrun_multichip

    worst = dryrun_multichip(2, backbone="resnet18equiv")
    assert set(worst) == {"equal", "unequal"} and all(v <= 1.0 for case in worst.values() for v in case.values())
