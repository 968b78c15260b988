"""The port's 3D training CLI and the held-out protocol's arguments, on the
CPU: ``cli/train_3d.py``'s ``run_3d`` without ``--evaluate`` trains, keeps
its config, checkpoints and resumes; ``Trainer.fit`` with the fragment
adapter draws the JAX trainer's batches; ``cli/train_3d_missing.py`` has its
defaults; ``train/heldout3d.py`` builds the script's wall-surface corpus and
samples at the protocol's ratio.

Corpora are compared exactly (the data module is a byte-identical copy of
the JAX package's); the CLI runs are held to what they write.
"""

import dataclasses
import json
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from diffassemble_tpu.data import breaking_bad as jbb
from diffassemble_tpu.train import trainer as jtrainer
from diffassemble_tpu_torch.cli import train_3d, train_3d_missing
from diffassemble_tpu_torch.data import breaking_bad as tbb
from diffassemble_tpu_torch.models import Diffusion3D, Diffusion3DConfig
from diffassemble_tpu_torch.train import heldout3d
from diffassemble_tpu_torch.train import trainer as ttrainer
from torch_parity import ROOT

FLAGS = ["--dataset", "synthetic", "--backbone", "vn_dgcnn_rich", "--n_layers", "1", "--num_points", "32",
         "--max_num_part", "3", "--batch_size", "2", "--train_n", "4", "--test_n", "2", "--rel_pose_weight", "0.5",
         "--rel_condition", "1", "--aux_pose_weight", "0.5", "--rot_pt_l2_weight", "1.0",
         "--synthetic_canonical", "0.9", "--wall_detail", "0.08", "--wall_boost", "3", "--compute_dtype", "float32",
         "--encoder_init", str(ROOT / "weights" / "vn_dgcnn_rich_rel3d_512.npz"), "--seed", "2", "--device", "cpu"]


def _args(run_dir, *extra):
    ap = train_3d.argparse.ArgumentParser()
    train_3d.add_3d_args(ap)
    return ap.parse_args([*FLAGS, "--run_dir", str(run_dir), *extra])


def _records(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_run_3d_trains_checkpoints_and_resumes(tmp_path, capsys):
    run = tmp_path / "run"
    assert train_3d.run_3d(_args(run, "--max_steps", "2")) is None
    ckpts = run / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir() if p.name.isdigit()) == ["2"]
    saved = json.loads((ckpts / "config.json").read_text())
    assert saved == dataclasses.asdict(train_3d.config_from_args(_args(run)))
    assert saved["backbone"] == "vn_dgcnn_rich" and saved["rel_condition"] and saved["warmup_steps"] == 500
    first = torch.load(ckpts / "2" / "state.pt", weights_only=True)
    assert first["step"] == 2 and first["opt_state"]["count"] == 2

    train_3d.run_3d(_args(run, "--max_steps", "3"))
    assert "resumed from step 2" in capsys.readouterr().out
    assert sorted(p.name for p in ckpts.iterdir() if p.name.isdigit()) == ["3"]
    last = torch.load(ckpts / "3" / "state.pt", weights_only=True)
    assert last["step"] == 3 and last["opt_state"]["count"] == 3
    moved = [k for k in last["params"] if not torch.equal(last["params"][k], first["params"][k])]
    assert any(k.startswith("encoder.") for k in moved) and any(k.startswith("denoiser.") for k in moved)

    records = _records(run)
    sanity = [r for r in records if "sanity/rmse_t_AVG" in r]
    steps = [r for r in records if "loss" in r]
    assert len(sanity) == 2 and [r["step"] for r in steps] == [1]  # logged at step 1 (and every 50)
    keys = {"trans_loss", "rot_pt_cd_loss", "transform_pt_cd_loss", "rot_loss", "rot_pt_l2_loss", "aux_pose_loss",
            "rel_rot_loss", "rel_off_loss", "rel_conf_loss", "grad_norm/encoder", "grad_norm/rel_head",
            "grad_norm/denoiser"}
    assert keys <= set(steps[0]) and all(np.isfinite(steps[0][k]) for k in keys)
    assert steps[0]["grad_nonfinite"] == 0.0 and steps[0]["grad_norm/encoder"] > 0


def test_fragment_fit_draws_the_jax_trainers_batches(tmp_path):
    """With part dropout the adapter's rng is drawn by the one-sample collate
    that the JAX ``fit`` makes before training, then by each batch."""
    args = _args(tmp_path / "run", "--missing", "40", "--min_num_part", "3")
    model, train_ds, _, cats = train_3d.build_3d(args)
    got = []
    trainer = ttrainer.Trainer(model, run_dir=str(tmp_path / "run"), max_steps=2, batch_size=2, seed=2,
                               adapter=ttrainer.fragment_adapter(3, cats, missing_perc=40, seed=2))

    def capture(state, batch):
        got.append(batch)
        return state._replace(step=state.step + 1), {"grad_norm": torch.tensor(1.0), "grad_nonfinite": 0.0}

    trainer.train_step = capture
    trainer.fit(train_ds)

    adapter = jtrainer.fragment_adapter(3, cats, missing_perc=40, seed=2)
    host_rng = np.random.default_rng(2)
    adapter.collate([train_ds[0]], 3)
    want = list(jtrainer.batch_iterator(train_ds, 2, 3, host_rng, collate=adapter.collate))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.array_equal(g.node_mask.numpy(), w.node_mask) and np.array_equal(g.pcds.numpy(), w.pcds)
    kept = [(int(g.node_mask[j].sum()), min(train_ds[int(i)]["n_parts"], 3)) for g in got
            for j, i in enumerate(g.index)]
    assert all(k <= n for k, n in kept) and any(k < n for k, n in kept)  # parts were dropped


def test_train_3d_missing_has_its_defaults(tmp_path):
    seen = []
    argv = ["train_3d_missing", *FLAGS, "--run_dir", str(tmp_path)]
    with mock.patch.object(train_3d_missing, "run_3d", seen.append), mock.patch.object(sys, "argv", argv):
        train_3d_missing.main()
    assert seen[0].missing == 20 and seen[0].num_iter == 3 and not seen[0].evaluate
    ap = train_3d.argparse.ArgumentParser()
    train_3d.add_3d_args(ap)
    plain = ap.parse_args(FLAGS)
    assert plain.missing == 0 and plain.num_iter == 1


OTHER_BACKBONES = {"pointnet": ["--backbone", "pointnet"], "pointnet_inv": ["--backbone", "pointnet_inv"],
                   "pointnet_plus": ["--backbone", "pointnet_plus"], "vnn": ["--backbone", "vnn"],
                   "vn_dgcnn_equiv_inv_mp": ["--backbone", "vn_dgcnn", "--equiv_inv_mp", "1"]}


@pytest.mark.parametrize("name", sorted(OTHER_BACKBONES))
def test_run_3d_trains_and_evaluates_each_other_backbone(name, tmp_path):
    """Every encoder of the table, and split message passing, through the
    CLI: one step, a checkpoint, then ``--evaluate`` on it (T = 20, so a
    sampling runs 2 reverse steps)."""
    run = tmp_path / "run"
    flags = ["--dataset", "synthetic", *OTHER_BACKBONES[name], "--steps", "20", "--n_layers", "2", "--num_points", "32",
             "--max_num_part", "3", "--batch_size", "2", "--train_n", "2", "--test_n", "2", "--compute_dtype",
             "float32", "--seed", "1", "--device", "cpu", "--run_dir", str(run)]
    ap = train_3d.argparse.ArgumentParser()
    train_3d.add_3d_args(ap)
    assert train_3d.run_3d(ap.parse_args([*flags, "--max_steps", "1"])) is None
    saved = json.loads((run / "checkpoints" / "config.json").read_text())
    assert saved["backbone"] == OTHER_BACKBONES[name][1] and saved["equiv_inv_mp"] == (name == "vn_dgcnn_equiv_inv_mp")
    steps = [r for r in _records(run) if "loss" in r]
    assert len(steps) == 1 and np.isfinite(steps[0]["loss"]) and steps[0]["grad_norm/encoder"] > 0
    metrics = train_3d.run_3d(ap.parse_args([*flags, "--evaluate", "true"]))
    assert np.isfinite(metrics["rmse_t_AVG"][0])


def test_train_3d_missing_trains_on_the_cpu(tmp_path):
    argv = ["train_3d_missing", *FLAGS, "--run_dir", str(tmp_path / "run"), "--max_steps", "1",
            "--min_num_part", "3"]
    with mock.patch.object(sys, "argv", argv):
        train_3d_missing.main()
    assert (tmp_path / "run" / "checkpoints" / "1" / "state.pt").is_file()


# ------------------------------------------------ the held-out protocol's arguments


def test_protocol_corpus_with_wall_surface_is_the_jax_packages():
    kw = dict(num_points=48, max_num_part=4, min_num_part=2, wall_detail=0.08, wall_boost=3, canonical=0.9,
              seed=1)
    got = heldout3d.protocol_dataset(test_n=3, wall_surface=True, wall_freq=5.0, **kw)
    _, want, _ = jbb.get_dataset_3d("synthetic", train_n=4, test_n=3, voronoi=True, wall_surface=True,
                                    wall_freq=5.0, **kw)
    _, plain, _ = jbb.get_dataset_3d("synthetic", train_n=4, test_n=3, voronoi=True, **kw)
    for i in range(3):
        a, b = want[i], got[i]
        assert a.keys() == b.keys() and all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)
    assert any(not np.array_equal(got[i]["pcds"], plain[i]["pcds"]) for i in range(3))


@pytest.mark.parametrize("protocol_extra", [{"ratio": 2, "wall_surface": 1, "wall_freq": 5.0}, {}],
                         ids=["ratio_2_wall_surface", "script_defaults"])
def test_run_protocol_takes_the_ratio_and_the_wall_flags(monkeypatch, protocol_extra):
    protocol = dict(test_n=2, batch=2, num_points=32, max_num_part=3, min_num_part=2, wall_detail=0.08,
                    wall_boost=3, canonical=0.9, seed=0, **protocol_extra)
    model = Diffusion3D(Diffusion3DConfig(backbone="vn_dgcnn_rich", n_layers=1, hidden_dim=16, heads=2,
                                          max_num_part=3, rel_condition=True, rel_k=4), device="cpu")
    ratios, built = [], []
    sample = model.sample

    def recording_sample(batch, generator=None, keep_trajectory=False, inference_ratio=None):
        ratios.append(inference_ratio)
        return sample(batch, generator, keep_trajectory, inference_ratio)

    def recording_dataset(*args, **kwargs):
        built.append(kwargs)
        return tbb.get_dataset_3d(*args, **kwargs)

    monkeypatch.setattr(model, "sample", recording_sample)
    monkeypatch.setattr(heldout3d, "get_dataset_3d", recording_dataset)
    result = heldout3d.run_protocol(model, protocol)
    assert ratios == [protocol_extra.get("ratio")] and result["n_parts"] > 0
    assert built[0]["wall_surface"] == bool(protocol_extra.get("wall_surface", 0))
    assert built[0]["wall_freq"] == protocol_extra.get("wall_freq", 14.0)
    # the sampler takes the ratio: 300 steps at ratio 2 are 150 denoiser calls
    calls = []
    monkeypatch.setattr(model, "denoise", lambda *a, **k: calls.append(1) or torch.zeros((1, 3, 7)))
    nb = tbb.collate_fragments([tbb.get_dataset_3d("synthetic", train_n=2, test_n=1, num_points=32,
                                                   max_num_part=3)[1][0]], 3).to("cpu")
    sample(nb, inference_ratio=2)
    assert len(calls) == 150
