"""The port's data-parallel training and the trainer's guards, on the CPU:
the dryrun twin (2 gloo ranks under DDP against one process, with equal and
with unequal valid-node counts per rank), a world of one under DDP bit-equal
to the plain step, the mesh helpers (the rank layout of a dp × tp mesh; a
tensor-parallel mesh needs a process for each of its places),
``-gpus`` clamped to the run's processes, and the preemption and
round-deadline guards of ``Trainer.fit``.

Tolerances (``parallel/dryrun.py``): the loss within 1e-5 relative, each
gradient within 1e-4 of its parameter's largest entry plus 1e-6 of the
model's, the parameters after the step within 1e-4 of the largest step plus
1e-6 relative (where an unfactored gradient is within the gradient tolerance
of 0, only within the largest step); a world of one bit-equal.
"""

import argparse
import json
import os
import signal

import numpy as np
import pytest
import torch
import torch.distributed as dist

from diffassemble_tpu.parallel import mesh as jmesh
from diffassemble_tpu_torch.cli import common
from diffassemble_tpu_torch.data import PuzzleBatch, make_puzzle
from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
from diffassemble_tpu_torch.parallel import distributed, dryrun, mesh
from diffassemble_tpu_torch.train import trainer
from torch_parity import CFG, small_batch


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_dryrun_two_gloo_ranks_match_one_process():
    out = dryrun.dryrun_multichip(2)
    assert set(out) == {"equal", "unequal"}
    assert all(v <= 1.0 for worst in out.values() for v in worst.values())


def test_a_world_of_one_under_ddp_is_bit_equal_to_the_plain_step():
    cfg = Diffusion2DConfig(**{**CFG, "n_layers": 1})
    batch = PuzzleBatch(*small_batch(seed=4)).to("cpu")
    n = dryrun.one_rank_ddp_matches(lambda: Diffusion2D(cfg, device="cpu", seed=2), batch, "gloo")
    assert n == len(list(Diffusion2D(cfg, device="cpu").parameters()))
    assert not dist.is_initialized()


def test_mesh_single_process_and_tensor_parallel_refusal():
    assert not dist.is_initialized() and distributed.is_main_process()
    assert distributed.initialize() is False and not dist.is_initialized()  # a single process: no-op
    m = mesh.auto_mesh(6)
    assert (m.dp, m.tp, m.rank, m.distributed) == (1, 1, 0, False) and m.shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="one process per device"):
        mesh.make_mesh(2)
    # tensor parallelism works, but a single process cannot hold a place for each tp rank
    with pytest.raises(ValueError, match=r"dp\(0\)\*tp\(2\) != devices\(1\)"):
        mesh.make_mesh(1, tp=2)
    with pytest.raises(ValueError, match="a mesh of 2 devices in a run of 1 processes"):
        mesh.auto_mesh(8, tp=2)
    model = Diffusion2D(Diffusion2DConfig(**{**CFG, "n_layers": 1}), device="cpu")
    assert mesh.param_sharding_rules(m, model) == dict.fromkeys(k for k, _ in model.named_parameters())
    assert mesh.shard_params(m, model) is None and getattr(model, "tp_layout", None) is None
    tp_rules = mesh.param_sharding_rules(mesh.Mesh(dp=1, tp=2), model)
    assert tp_rules["denoiser.gnn.transformer.layers.0.query.weight"] == 0
    assert tp_rules["denoiser.fusion.fc2.weight"] == 1 and tp_rules["encoder.conv_stem.weight"] is None
    batch = small_batch(b=4)
    part = mesh.shard_batch(mesh.Mesh(dp=2, rank=1), batch)
    assert all(np.array_equal(f, g[2:]) for f, g in zip(part, batch))
    part = mesh.shard_batch(mesh.Mesh(dp=2, tp=2, rank=3), batch)  # dp place 1 of 2
    assert all(np.array_equal(f, g[2:]) for f, g in zip(part, batch))
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(mesh.Mesh(dp=3), batch)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (4, 2), (1, 4), (2, 4)])
def test_mesh_places_ranks_as_the_jax_mesh_lays_out_devices(dp, tp):
    """Rank r sits at (r // tp, r % tp), where the JAX package's mesh puts
    device r (its devices reshaped to (dp, tp)); a dp group holds the ranks
    at one tp place, a tp group the consecutive ranks at one dp place."""
    layout = np.arange(dp * tp).reshape(dp, tp)
    dp_groups, tp_groups = mesh.mesh_groups(dp, tp)
    assert dp_groups == [layout[:, t].tolist() for t in range(tp)]
    assert tp_groups == [layout[d].tolist() for d in range(dp)]
    for r in range(dp * tp):
        m = mesh.Mesh(dp=dp, tp=tp, rank=r, distributed=True)
        assert layout[m.dp_rank, m.tp_rank] == r
        assert r in dp_groups[m.tp_rank] and r in tp_groups[m.dp_rank]
        assert m.tensor_parallel.size == tp and m.tensor_parallel.rank == m.tp_rank


@pytest.mark.parametrize("batch_size", [8, 16, 6, 3])
def test_auto_mesh_makes_the_jax_choice(batch_size, monkeypatch):
    """dp is the largest divisor of the batch that fits the run, as the JAX
    ``auto_mesh`` chooses it over 8 devices; a mesh that would leave some of
    the run's 8 processes without a place raises."""
    want = jmesh.auto_mesh(batch_size).shape["dp"]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 3)
    if want == 8:
        assert mesh.auto_mesh(batch_size) == mesh.Mesh(dp=8, tp=1, rank=3, distributed=True)
    else:
        with pytest.raises(ValueError, match=f"a mesh of {want} devices in a run of 8 processes"):
            mesh.auto_mesh(batch_size)


def test_gpus_two_clamps_to_the_runs_one_process(monkeypatch, tmp_path, capsys):
    seen = {}
    monkeypatch.setattr(trainer.Trainer, "fit", lambda self, *a, **k: seen.setdefault("mesh", self.mesh))
    ap = argparse.ArgumentParser()
    common.add_2d_args(ap)
    args = ap.parse_args(["-gpus", "2", "--backbone", "efficientnet_b0", "-dataset", "synthetic",
                          "-puzzle_sizes", "3", "--n_layers", "1", "--compute_dtype", "float32",
                          "--run_dir", str(tmp_path / "run"), "--device", "cpu"])
    common.run_2d(args)
    assert seen["mesh"] == mesh.Mesh(dp=1, tp=1, rank=0, distributed=False)
    assert "-gpus 2: this run has 1 process(es)" in capsys.readouterr().out


class _ListDataset:
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


def test_preemption_guard_checkpoints_and_returns(tmp_path):
    """SIGTERM during step 2: the step ends, a checkpoint is saved and fit
    returns; the earlier SIGTERM handler is back afterwards."""
    previous = signal.getsignal(signal.SIGTERM)
    tr = _tiny_trainer(tmp_path / "run", max_steps=50)
    inner = tr.train_step

    def step(state, batch):
        if state.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(state, batch)

    tr.train_step = step
    state = tr.fit(_ListDataset(4, seed=1))
    assert state.step == 2 and tr.ckpt.latest_step() == 2
    assert signal.getsignal(signal.SIGTERM) is previous


def test_round_deadline_guard_evaluates_checkpoints_and_returns(tmp_path, monkeypatch):
    """The guard reads the clock every 50 steps only; past the cutoff it
    evaluates, checkpoints with the metrics and returns."""
    checks = []

    def time_left(margin):
        checks.append(margin)
        return -1.0

    monkeypatch.setattr(trainer, "_deadline_time_left", time_left)
    tr = _tiny_trainer(tmp_path / "run", max_steps=200, deadline_margin=600.0)
    # a step that only counts: the guard is under test
    tr.train_step = lambda state, batch: (state._replace(step=state.step + 1), {
        "grad_norm": torch.tensor(1.0), "grad_nonfinite": torch.tensor(0.0)})
    state = tr.fit(_ListDataset(4, seed=2), eval_ds=_ListDataset(2, seed=3))
    assert state.step == 50 and checks == [600.0] and tr.ckpt.latest_step() == 50
    saved = json.loads((tmp_path / "run" / "checkpoints" / "50" / "metrics.json").read_text())
    assert saved["overall_nImages"] == 2
