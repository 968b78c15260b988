"""The port's trainer, checkpoints, datasets and CLI, on the CPU: gradient
accumulation against the full batch, checkpoint round trip, top-k and
resume, the sanity and periodic evaluation, the dead-gradient tripwire,
``encoder_init`` from an npz the JAX package wrote, the datasets byte-equal
to the JAX package's, and a 3-step run of the rotation CLI.

Tolerance: parameters after an accumulated step within 1e-5 of the largest
update of the full-batch step (the same float32 sums split in two) plus 1e-6
relative (a few float32 ulps of the parameter the update is added to),
except where an unfactored parameter's gradient is within 1e-5 of its
largest entry plus 1e-6 of the model's largest entry of 0
(``torch_parity.assert_same_step``).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.data import collate_puzzles as jcollate
from diffassemble_tpu.data import datasets as jdatasets
from diffassemble_tpu.nn import efficientnet as jeff
from diffassemble_tpu.utils.params import save_params as jsave_params
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.cli import common, train_2d_rot
from diffassemble_tpu_torch.data import PuzzleBatch, collate_puzzles, make_puzzle
from diffassemble_tpu_torch.data import datasets as tdatasets
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.train import checkpoint, train_state, trainer
from diffassemble_tpu_torch.utils import params as tparams
from torch_assets import fixed_eigsh
from torch_parity import CFG, ROOT, assert_same_step, seeded_params, small_batch


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads: the suite runs several test processes on one
    machine, and more threads than cores make torch's CPU kernels spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _affine_model(seed=0):
    """BatchNorm in "affine" mode: no statistics across the batch, so a
    microbatch's features do not depend on the other microbatch."""
    cfg = {**CFG, "n_layers": 1, "visual_pretrained": True, "warmup_steps": 0}
    return Diffusion2D(Diffusion2DConfig(**cfg), device="cpu", seed=seed)


def test_accumulation_two_matches_the_full_batch():
    """Two microbatches of one puzzle each (same valid-node count) give the
    full batch's mean gradient, so the step lands on the same parameters
    (within 1e-5 of the largest update)."""
    batch = PuzzleBatch(*small_batch(seed=12)).to("cpu")
    batch = batch._replace(node_mask=torch.ones_like(batch.node_mask),
                           adj=torch.ones_like(batch.adj))  # equal valid counts in both halves
    rng = np.random.default_rng(13)
    t = torch.as_tensor(rng.integers(0, 300, 2))
    noise = torch.as_tensor(rng.standard_normal(tuple(batch.x0.shape)).astype(np.float32))
    keep = torch.tensor([True, False]).reshape(2, 1, 1)
    results = []
    for acc in (1, 2):
        model = _affine_model()
        opt = model.make_optimizer()
        state = train_state.create_train_state(model, opt, torch.Generator().manual_seed(0))
        halves = iter([dict(t_graph=t[i:i + 1], noise=noise[i:i + 1], cf_keep=keep[i:i + 1]) for i in range(2)])
        full = dict(t_graph=t, noise=noise, cf_keep=keep)
        loss_fn = (lambda b, g: model.loss(b, g, **full)) if acc == 1 else (lambda b, g: model.loss(b, g, **next(halves)))
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        state, aux = train_state.make_train_step(loss_fn, opt, accumulate=acc)(state, batch)
        # accumulation reports the mean total loss as "loss", as the JAX step does
        loss = aux["total_loss"] if acc == 1 else aux["loss"]
        results.append((before, dict(model.named_parameters()), float(loss), state.opt_state))
    (b0, full_p, full_loss, opt_state), (_, acc_p, acc_loss, _) = results
    np.testing.assert_allclose(acc_loss, full_loss, rtol=1e-5)
    gmax = max(float(p.grad.abs().max()) for p in full_p.values())
    for k, p in full_p.items():
        g_tol = 1e-5 * float(p.grad.abs().max()) + 1e-6 * gmax
        assert_same_step(acc_p[k].detach(), p.detach(), b0[k], p.grad, k in opt_state["v"], g_tol, 1e-5, k)


class _ListDataset:
    """A few fixed puzzles: len, indexing and max_nodes, as PuzzleDataset has."""

    max_nodes = 9

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.items = [make_puzzle(rng.random((96, 96, 3)).astype(np.float32), 3, 3, 32, rotation=True, rng=rng)
                      for _ in range(n)]
        for s in self.items:
            s["patches_dim"] = np.array([3, 3], dtype=np.int32)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _tiny_trainer(run_dir, **kw):
    model = Diffusion2D(Diffusion2DConfig(**{**CFG, "n_layers": 1, "inference_ratio": 150}), device="cpu")
    return trainer.Trainer(model, run_dir=str(run_dir), batch_size=2, **kw)


def test_checkpoint_round_trip_top_k_and_resume(tmp_path):
    tr = _tiny_trainer(tmp_path / "run", max_steps=2, checkpoint_every=1, ema_decay=0.9)
    ds = _ListDataset(4, seed=1)
    state = tr.fit(ds, eval_ds=None)
    assert state.step == 2 and tr.ckpt.latest_step() == 2
    assert json.loads((tmp_path / "run" / "checkpoints" / "config.json").read_text())["n_layers"] == 1

    # a fresh trainer restores exactly what was saved, then continues to max_steps
    tr2 = _tiny_trainer(tmp_path / "run", max_steps=3, checkpoint_every=1, ema_decay=0.9)
    template = tr2.new_state()
    restored = tr2.ckpt.restore(template)
    assert restored.step == 2 and restored.opt_state["count"] == 2
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    for k, p in state.params.items():
        assert torch.equal(restored.params[k], p) and torch.equal(restored.ema_params[k], state.ema_params[k])
    for key in ("v_row", "v_col", "v"):
        assert all(torch.equal(restored.opt_state[key][k], v) for k, v in state.opt_state[key].items())
    resumed = tr2.fit(ds, eval_ds=None)
    assert resumed.step == 3 and tr2.ckpt.latest_step() == 3
    assert checkpoint.load_config_near(tmp_path / "run")["n_layers"] == 1
    explicit = checkpoint.restore_explicit(tmp_path / "run" / "checkpoints" / "3", tr2.new_state())
    assert explicit.step == 3
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_explicit(tmp_path / "nowhere", tr2.new_state())

    # top-k by the monitored metric plus the latest
    mgr = checkpoint.CheckpointManager(tmp_path / "topk", keep_top_k=2)
    for step, acc in ((10, 0.5), (20, 0.9), (30, 0.1), (40, 0.7)):
        mgr.save(step, state, {"overall_acc": acc})
    mgr.save(50, state)
    assert checkpoint._steps(mgr.directory) == [20, 40, 50]
    assert mgr.best_step() == 20 and mgr.latest_step() == 50


def test_fit_evaluates_and_monitors(tmp_path):
    """Sanity eval, a periodic eval whose metrics decide the kept checkpoints,
    and the metrics log."""
    tr = _tiny_trainer(tmp_path / "run", max_steps=2, eval_every=2)
    ds = _ListDataset(4, seed=2)
    tr.fit(ds, eval_ds=_ListDataset(2, seed=3))
    recs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert "sanity/overall__piece_acc" in recs[0] and any("val/overall_acc" in r for r in recs)
    assert "grad_norm/encoder" in recs[1] and np.isfinite(recs[1]["loss"])
    assert json.loads((tmp_path / "run" / "checkpoints" / "2" / "metrics.json").read_text())["overall_nImages"] == 2


def test_dead_gradient_tripwire(tmp_path):
    tr = _tiny_trainer(tmp_path / "run", max_steps=10, dead_grad_patience=2)
    model = tr.model
    tr.train_step = train_state.make_train_step(
        lambda b, g: (sum(p.sum() for p in model.parameters()) * 0.0, {}), tr.optimizer)
    with pytest.raises(trainer.DeadGradientError):
        tr.fit(_ListDataset(6, seed=4), eval_ds=None)
    assert tr.ckpt.latest_step() == 2


def test_encoder_init_from_a_jax_npz(tmp_path):
    enc = seeded_params(jeff.EfficientNetB0Features(), 8, jnp.zeros((1, 32, 32, 3)))
    path = tmp_path / "enc.npz"
    jsave_params(path, {"encoder": enc})
    loaded = tparams.load_params(path)
    assert tparams.tree_shapes_match(loaded["encoder"], jax.tree_util.tree_map(np.asarray, enc))
    model = Diffusion2D(Diffusion2DConfig(**{**CFG, "encoder_init": str(path)}), device="cpu")
    model.init(0)
    ref = convert.convert_params({"encoder": jax.tree_util.tree_map(np.asarray, enc)})
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, ref[f"encoder.{k}"])
    tparams.save_params(tmp_path / "bad.npz", {"encoder": {"conv_stem": {"kernel": np.zeros((3, 3, 3, 8))}}})
    bad = Diffusion2D(Diffusion2DConfig(**{**CFG, "encoder_init": str(tmp_path / "bad.npz")}), device="cpu")
    with pytest.raises(ValueError, match="encoder_init"):
        bad.init(0)


@pytest.fixture
def deterministic_eigsh():
    """ARPACK starts from a random vector of its own, so the kept expander
    varies from call to call in both packages alike; a fixed start vector
    makes the comparison exact."""
    with fixed_eigsh():
        yield


@pytest.mark.parametrize("kw", [
    dict(dataset="synthetic", degree="60%", unique_graph=True, missing_perc=20, inf_fully=False),
    dict(dataset="synthetic_art", degree=-1, padding=2),
    dict(dataset="synthetic", degree="60%", random_dropout=0.5, hf_detail=0.25, canonical=0.8, inf_fully=False),
])
def test_datasets_identical(kw, deterministic_eigsh):
    # one puzzle size: the images are generated at that size (other sizes need a PIL resize)
    common_kw = dict(puzzle_sizes=[(3, 3)], rotation=True, train_n=3, test_n=2, seed=5)
    a = jdatasets.get_dataset(**common_kw, **kw)
    b = tdatasets.get_dataset(**common_kw, **kw)
    assert a[2] == b[2]
    for ds_a, ds_b in zip(a[:2], b[:2]):
        assert len(ds_a) == len(ds_b) and ds_a.max_nodes == ds_b.max_nodes
        for i in range(len(ds_a)):
            for _ in range(2):  # the image cache's second read too
                sa, sb = ds_a[i], ds_b[i]
                assert sa.keys() == sb.keys()
                for key in sa:
                    va, vb = np.asarray(sa[key]), np.asarray(sb[key])
                    assert va.dtype == vb.dtype and np.array_equal(va, vb), key
        samples = [ds_b[i] for i in range(len(ds_b))]
        for x, y in zip(jcollate(samples, ds_b.max_nodes), collate_puzzles(samples, ds_b.max_nodes)):
            assert np.array_equal(x, y)


def test_image_folders_and_resizing_need_pil_and_say_so():
    with pytest.raises(NotImplementedError, match="PIL"):
        tdatasets.get_dataset("celeba", puzzle_sizes=[3])
    train, _, _ = tdatasets.get_dataset("synthetic", puzzle_sizes=[3, (2, 4)], train_n=4, seed=5)
    with pytest.raises(NotImplementedError, match="PIL"):
        [train[i] for i in range(len(train))]  # a 2×4 puzzle cut from a 4×4 image needs a resize


def _cli(*args, cwd):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", "diffassemble_tpu_torch.cli.train_2d_rot", *args],
                          capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_cli_trains_three_steps_then_evaluates_on_the_cpu(tmp_path, capsys, monkeypatch):
    flags = ["--backbone", "efficientnet_b0", "-dataset", "synthetic", "-puzzle_sizes", "3", "-steps", "20",
             "-batch_size", "2", "--n_layers", "1", "--degree", "60%", "--unique_graph", "true",
             "--compute_dtype", "float32", "--aux_loss_weight", "0.1", "--run_dir", str(tmp_path / "run"),
             "--device", "cpu"]
    res = _cli(*flags, "-max_steps", "3", cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "run" / "checkpoints" / "3" / "state.pt").is_file()
    recs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert recs[0]["step"] == 0 and recs[1]["step"] == 1 and np.isfinite(recs[1]["loss"])
    monkeypatch.setattr(sys, "argv", ["train_2d_rot", *flags, "--evaluate", "true"])
    train_2d_rot.main()  # in this process: restores step 3 and evaluates
    assert "overall_acc" in capsys.readouterr().out.splitlines()[-1]


@pytest.mark.parametrize("backbone, item", [("tiny", 6), ("convnet", 6), ("resnet18equiv", 13),
                                            ("resnet34equiv", 13), ("resnet50equiv", 13)])
def test_cli_refusal_names_the_backbones_roadmap_item(backbone, item):
    """The light encoders are still refused, naming item 6; item 13's
    equivariant ResNets are ported and build with their encoder."""
    ap = argparse.ArgumentParser()
    common.add_2d_args(ap)
    args = ap.parse_args(["--device", "cpu", "--backbone", backbone, "--n_layers", "1"])
    if item == 6:
        with pytest.raises(NotImplementedError, match=rf"{backbone}.*ROADMAP Queue 1 item {item}$"):
            common.build_2d_model(args)
    else:
        from diffassemble_tpu_torch.nn.visual import EQUIVARIANT_BACKBONES

        model = common.build_2d_model(args)
        assert model.cfg.backbone == backbone
        assert type(model.encoder) is type(EQUIVARIANT_BACKBONES[backbone]())


def test_cli_builds_the_flagship_and_refuses_what_is_not_ported():
    """The rotation CLI's defaults (resnet18equiv) and ``--discrete`` build;
    a light encoder is refused."""
    from diffassemble_tpu_torch.models import DiscreteDiffusion2D, DiscreteDiffusion2DRot

    ap = argparse.ArgumentParser()
    common.add_2d_args(ap)
    ap.set_defaults(rotation=True, predict_xstart=True, degree="60%", virt_nodes=8, backbone="resnet18equiv",
                    architecture="exophormer")
    args = ap.parse_args(["--device", "cpu", "--n_layers", "1"])
    assert common.build_2d_model(args).cfg.backbone == "resnet18equiv"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        common.build_2d_model(ap.parse_args(["--device", "cpu", "--backbone", "tiny"]))
    rot = common.build_2d_model(ap.parse_args(["--device", "cpu", "--backbone", "efficientnet_b0", "--n_layers", "1",
                                               "--discrete", "true", "-puzzle_sizes", "3"]))
    assert type(rot) is DiscreteDiffusion2DRot and rot.cfg.n_classes == 9
    assert rot.cfg.discrete_loss == "cross_entropy"  # huber is no discrete loss: the JAX CLI's fallback
    flat = common.build_2d_model(ap.parse_args(["--device", "cpu", "--backbone", "efficientnet_b0", "--n_layers",
                                                "1", "--discrete", "true", "--rotation", "false", "--loss_type",
                                                "vb"]))
    assert type(flat) is DiscreteDiffusion2D and flat.cfg.discrete_loss == "vb" and flat.cfg.n_classes == 36
    args = ap.parse_args(["--backbone", "efficientnet_b0", "--degree", "10%", "--aux_loss_weight", "0.1",
                          "--device", "cpu"])
    flagship = json.loads((ROOT / "weights" / "diffusion2d_rot30" / "config.json").read_text())
    cfg = dataclasses.asdict(common.build_2d_model(args).cfg)
    for key in ("steps", "mean_type", "rotation", "architecture", "n_layers", "virt_nodes", "hidden_dim",
                "heads", "warmup_steps", "aux_loss_weight", "compute_dtype", "loss_type"):
        assert cfg[key] == flagship[key], key
