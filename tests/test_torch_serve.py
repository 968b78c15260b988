"""Serving and evaluating a run of the port's own trainer, on the CPU.

A 3-step run of the rotation CLI with ``--ema_decay`` set writes a checkpoint
that holds both the live params and their EMA. As the JAX package's
``cli/serve.py`` and ``cli/common.py`` choose:

- ``PuzzleSolver.from_run(run_dir)`` serves ``eval_params`` of the latest
  checkpoint (the EMA);
- ``PuzzleSolver.from_run(run_dir, checkpoint_path=...)`` serves that
  checkpoint's live params;
- ``--evaluate --checkpoint_path`` hands ``Trainer.evaluate`` the live params.

Each solver is held against a solver built from the same weights given as a
state_dict: the same seeds on the CPU give the same positions exactly.
"""

import sys

import numpy as np
import pytest
import torch

from diffassemble_tpu_torch.cli import serve, train_2d_rot
from diffassemble_tpu_torch.cli.serve import PuzzleSolver
from diffassemble_tpu_torch.models import Diffusion2DConfig
from diffassemble_tpu_torch.train import trainer

FLAGS = ["--backbone", "efficientnet_b0", "-dataset", "synthetic", "-puzzle_sizes", "3", "-steps", "20",
         "-batch_size", "2", "--n_layers", "1", "--degree", "60%", "--unique_graph", "true",
         "--compute_dtype", "float32", "--aux_loss_weight", "0.1", "--ema_decay", "0.9", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads: the suite runs several test processes on one
    machine, and more threads than cores make torch's CPU kernels spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A 3-step CPU run of the rotation CLI with EMA: (run dir, saved state)."""
    run_dir = tmp_path_factory.mktemp("serve") / "run"
    argv = ["train_2d_rot", *FLAGS, "--run_dir", str(run_dir), "-max_steps", "3"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", argv)
        train_2d_rot.main()
    saved = torch.load(run_dir / "checkpoints" / "3" / "state.pt", weights_only=True)
    # the EMA has moved away from the live params, so the two choices differ
    assert saved["ema_params"] is not None and saved["step"] == 3
    assert any(not torch.equal(saved["ema_params"][k], p) for k, p in saved["params"].items())
    return run_dir, saved


def _image():
    return np.random.default_rng(11).random((96, 96, 3)).astype(np.float32)


def _solver_with(run_dir, params):
    """A solver given ``params`` as a state_dict over the run's config."""
    cfg = Diffusion2DConfig(**serve.CheckpointManager(run_dir / "checkpoints").load_config())
    solver = PuzzleSolver(cfg, seed=0, device="cpu", puzzle_size=3)
    solver.model.load_state_dict({**solver.model.state_dict(), **params})
    return solver


def _assert_serves(solver, params):
    for k, p in solver.model.named_parameters():
        assert torch.equal(p.detach(), params[k]), k


@pytest.mark.parametrize("explicit", [False, True], ids=["run_dir", "checkpoint_path"])
def test_solver_serves_the_references_choice_of_params(run, explicit):
    """From the run dir: the latest checkpoint's eval_params (its EMA); from
    an explicit checkpoint path: its live params. Either serves the same
    positions as a solver given those params as a state_dict."""
    run_dir, saved = run
    kw = {"checkpoint_path": str(run_dir / "checkpoints" / "3")} if explicit else {}
    solver = PuzzleSolver.from_run(run_dir, puzzle_size=3, seed=0, device="cpu", **kw)
    want = saved["params"] if explicit else saved["ema_params"]
    _assert_serves(solver, want)
    patches, final = solver.predict_positions(_image())
    ref_patches, ref_final = _solver_with(run_dir, want).predict_positions(_image())
    assert final.shape == (9, 4) and np.isfinite(final).all()
    np.testing.assert_array_equal(final, ref_final)
    np.testing.assert_array_equal(patches, ref_patches)
    out = solver.predict_array(_image())
    assert out.shape == (96, 96, 3) and np.isfinite(out).all()


def test_serve_main_reads_a_run_dir(run, monkeypatch):
    """``serve --run_dir`` builds its solver through ``from_run`` and starts
    the HTTP server; without --run_dir or --config it refuses."""
    run_dir, saved = run
    built, started = [], []
    real = PuzzleSolver.from_run

    def recording_from_run(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    class FakeServer:
        def __init__(self, address, handler):
            self.address = address

        def serve_forever(self):
            started.append(self.address)

    monkeypatch.setattr(PuzzleSolver, "from_run", staticmethod(recording_from_run))
    monkeypatch.setattr("http.server.HTTPServer", FakeServer)
    monkeypatch.setattr(sys, "argv", ["serve", "--run_dir", str(run_dir), "--puzzle_size", "3",
                                      "--device", "cpu", "--port", "0"])
    serve.main()
    assert started == [("0.0.0.0", 0)] and len(built) == 1
    _assert_serves(built[0], saved["ema_params"])
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main()


@pytest.mark.parametrize("explicit", [False, True], ids=["latest", "checkpoint_path"])
def test_evaluate_hands_the_references_choice_of_params(run, explicit, monkeypatch):
    """``--evaluate --checkpoint_path`` evaluates the live params, as the JAX
    CLI does; without ``--checkpoint_path`` both packages evaluate
    ``eval_params`` of the latest checkpoint (the EMA)."""
    run_dir, saved = run
    seen = []

    def recording_evaluate(self, params, eval_ds, **kwargs):
        seen.append({k: p.detach().clone() for k, p in params.items()})
        return {"overall_acc": 0.0}

    monkeypatch.setattr(trainer.Trainer, "evaluate", recording_evaluate)
    extra = ["--checkpoint_path", str(run_dir / "checkpoints" / "3")] if explicit else []
    monkeypatch.setattr(sys, "argv", ["train_2d_rot", *FLAGS, "--run_dir", str(run_dir), "-max_steps", "3",
                                      "--evaluate", "true", *extra])
    train_2d_rot.main()
    assert len(seen) == 1
    want = saved["params"] if explicit else saved["ema_params"]
    for k, p in want.items():
        assert torch.equal(seen[0][k], p), k
