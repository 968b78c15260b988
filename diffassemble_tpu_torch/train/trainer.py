"""Training loop — port of the JAX package's ``train/trainer.py``, for both
tasks: puzzles (``puzzle_adapter``) and fragments (``fragment_adapter``).

- the train step of ``train_state.py`` over the data-parallel mesh
  (``parallel/mesh.py``: each process takes its slice of the global batch,
  the model runs under DDP), batches moved from the host by a prefetch
  thread;
- a sanity evaluation before training, periodic evaluation (the sampler plus
  greedy-assignment metrics, folded per puzzle size) and checkpointing with
  top-k by a monitored metric, and resume from the latest checkpoint; with
  ``calibrate_eval`` each evaluation first pools the OrientationNorm
  statistics over ``calibrate_batches`` eval batches and runs with them
  frozen (the model's own are put back after; a calibration that fails is
  skipped, never the evaluation);
- metric logging to stdout and ``metrics.jsonl``;
- the dead-gradient tripwire, the preemption guard (SIGTERM/SIGINT:
  checkpoint and return) and the round-deadline guard (``deadline_margin``:
  every 50 steps, an evaluation and a checkpoint once the round's cutoff is
  that near).

Only the main process logs, evaluates and saves; it evaluates the whole eval
batch on its own device, which gives the single-process metrics, while the
other ranks go on to the next step and wait for it there. The ranks agree on
every stop (preemption, deadline) before acting on it.

Not ported: reconstruction images (``_save_viz``, ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import time
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..data.batch import FragmentBatch, PuzzleBatch, collate_puzzles
from ..data.breaking_bad import collate_fragments
from ..data.prefetch import prefetch
from ..parallel.distributed import PreemptionGuard, is_main_process
from ..parallel.mesh import Mesh, auto_mesh, data_parallel_loss, shard_batch
from ..utils.deadline import time_left as _deadline_time_left
from .checkpoint import CheckpointManager
from .metrics import MeanMetrics, update_fragment_metrics, update_puzzle_metrics
from .train_state import TrainState, create_train_state, eval_params, make_train_step


class DeadGradientError(RuntimeError):
    """Raised by Trainer.fit when gradients are dead (exactly-zero norm or
    non-finite entries) for ``dead_grad_patience`` consecutive steps. Queue
    scripts must treat this as skip-to-next-job, not retry."""


class JsonlLogger:
    """Minimal metric sink (stdout + JSONL file)."""

    def __init__(self, run_dir: str | Path):
        self.path = Path(run_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, payload: dict) -> None:
        rec = {"step": int(step), "time": time.time(), **{k: _scalar(v) for k, v in payload.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        short = {k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in rec.items() if k != "time"}
        print(short, flush=True)


def _scalar(v):
    if isinstance(v, torch.Tensor):
        return float(v.detach().float().mean())
    if isinstance(v, np.ndarray):
        return float(v.mean())
    return v


def batch_iterator(
    dataset,
    batch_size: int,
    n_max: int,
    rng: np.random.Generator,
    shuffle: bool = True,
    collate=collate_puzzles,
) -> Iterable[Any]:
    """Host-side loader: shuffled epochs of padded batches."""
    idx = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(idx)
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        samples = [dataset[int(j)] for j in idx[i : i + batch_size]]
        yield collate(samples, n_max)


@dataclasses.dataclass
class TaskAdapter:
    """Task-specific hooks: how to collate, wrap, and fold metrics."""

    collate: Callable[[list, int], Any]
    batch_cls: type
    max_nodes: Callable[[Any], int]
    fold_metrics: Callable[[MeanMetrics, dict, Any], None]


def puzzle_adapter() -> TaskAdapter:
    return TaskAdapter(
        collate=collate_puzzles,
        batch_cls=PuzzleBatch,
        max_nodes=lambda ds: ds.max_nodes,
        fold_metrics=lambda agg, bm, nb: update_puzzle_metrics(agg, bm, nb.patches_dim, nb.node_mask),
    )


def fragment_adapter(
    max_num_part: int, category_names: list[str], missing_perc: int = 0, seed: int = 0
) -> TaskAdapter:
    """The 3D task: ``collate_fragments`` (its part dropout drawn from one
    ``default_rng(seed)`` for the adapter's life, as the JAX package's is),
    metrics folded per category and ``_AVG``."""
    rng = np.random.default_rng(seed)
    return TaskAdapter(
        collate=lambda samples, n_max: collate_fragments(samples, n_max, missing_perc=missing_perc, rng=rng),
        batch_cls=FragmentBatch,
        max_nodes=lambda ds: max_num_part,
        fold_metrics=lambda agg, bm, nb: update_fragment_metrics(agg, bm, nb.category, category_names),
    )


@contextlib.contextmanager
def swapped_params(model: torch.nn.Module, params: dict[str, torch.Tensor]):
    """Run the model with ``params`` (e.g. the EMA average) and put its own back after."""
    own = dict(model.named_parameters())
    if all(params[k] is p for k, p in own.items()):
        yield
        return
    saved = {k: p.detach().clone() for k, p in own.items()}
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(params[k])
    try:
        yield
    finally:
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(saved[k])


class Trainer:
    def __init__(
        self,
        model,
        run_dir: str = "runs/default",
        max_steps: int = 10_000,
        batch_size: int = 8,
        eval_every: int = 1000,
        checkpoint_every: int = 1000,
        accumulate: int = 1,
        monitor: str = "overall_acc",
        monitor_mode: str = "max",
        seed: int = 0,
        adapter: TaskAdapter | None = None,
        ema_decay: float | None = None,
        dead_grad_patience: int = 20,
        mesh: Mesh | None = None,
        deadline_margin: float | None = None,
        calibrate_eval: bool = True,
        calibrate_batches: int = 4,
    ):
        self.model = model
        self.device = model.device
        self.run_dir = Path(run_dir)
        self.max_steps = max_steps
        self.batch_size = batch_size
        self.eval_every = eval_every
        self.checkpoint_every = checkpoint_every
        self.seed = seed
        self.adapter = adapter or puzzle_adapter()
        self.logger = JsonlLogger(self.run_dir)
        # top-k by the monitored metric plus the latest
        self.ckpt = CheckpointManager(self.run_dir / "checkpoints", monitor, monitor_mode)
        self.ema_decay = ema_decay
        self.accumulate = accumulate
        self.mesh = mesh if mesh is not None else auto_mesh(batch_size)
        self.main = is_main_process()
        # round-deadline guard (utils/deadline.py): wind down this many
        # seconds before the round's cutoff (None = no guard)
        self.deadline_margin = deadline_margin
        # dead-gradient tripwire: grad_norm exactly 0 or non-finite gradients
        # for this many CONSECUTIVE steps aborts the run with a checkpoint
        # instead of stepping in place; 0/None disables it
        self.dead_grad_patience = dead_grad_patience
        self.calibrate_eval = calibrate_eval
        self.calibrate_batches = calibrate_batches

    # the optimizer and the train step are made when first used, so that an
    # evaluation needs neither
    @functools.cached_property
    def optimizer(self):
        return self.model.make_optimizer()

    @functools.cached_property
    def train_step(self):
        return make_train_step(data_parallel_loss(self.model, self.mesh), self.optimizer, self.accumulate,
                               ema_decay=self.ema_decay)

    def _device_batch(self, np_batch):
        return self.adapter.batch_cls(*np_batch).to(self.device)

    def new_state(self) -> TrainState:
        """Fresh seeded weights (and ``encoder_init``), optimizer state and generator."""
        self.model.init(self.seed)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return create_train_state(self.model, self.optimizer, gen, ema=self.ema_decay is not None)

    # ------------------------------------------------------------------- fit

    def fit(self, train_ds, eval_ds=None) -> TrainState:
        """Train from fresh weights, or resume from the run's latest checkpoint."""
        n_max = self.adapter.max_nodes(train_ds)
        host_rng = np.random.default_rng(self.seed)
        # the JAX fit collates one sample to initialise its model: the same
        # draw keeps a fragment adapter's part-dropout rng in step with it
        self.adapter.collate([train_ds[0]], n_max)
        state = self.new_state()
        restored = self.ckpt.restore(state)
        if restored is not None:
            state = restored
            print(f"resumed from step {state.step}", flush=True)
        if self.main:
            self.ckpt.save_config(self.model.cfg)

        if eval_ds is not None:  # sanity eval of one batch before training
            self.evaluate(eval_params(state), eval_ds, max_batches=1, tag="sanity")

        guard = PreemptionGuard().install()
        try:
            return self._loop(state, train_ds, eval_ds, n_max, host_rng, guard)
        finally:
            guard.uninstall()

    def _loop(self, state, train_ds, eval_ds, n_max, host_rng, guard) -> TrainState:
        step = state.step
        t_last = time.time()
        dead_streak = 0
        while step < self.max_steps:
            for nb in prefetch(batch_iterator(train_ds, self.batch_size, n_max, host_rng,
                                              collate=self.adapter.collate)):
                state, aux = self.train_step(state, self._device_batch(shard_batch(self.mesh, nb)))
                step = state.step
                if self.dead_grad_patience:
                    dead = float(aux["grad_norm"]) == 0.0 or float(aux["grad_nonfinite"]) >= 1.0
                    dead_streak = dead_streak + 1 if dead else 0
                    if dead_streak >= self.dead_grad_patience:
                        print(f"DEAD-GRADIENT TRIPWIRE: grad_norm==0 or non-finite for {dead_streak} "
                              f"consecutive steps at step {step} — checkpointing and aborting "
                              "(non-retryable)", flush=True)
                        self._save(step, state)
                        raise DeadGradientError(f"gradients dead for {dead_streak} steps at step {step}")
                if step % 50 == 0 or step == 1:
                    dt = time.time() - t_last
                    t_last = time.time()
                    self._log(step, {**aux, "steps_per_s": 50 / max(dt, 1e-9)})
                if eval_ds is not None and step % self.eval_every == 0:
                    self._save(step, state, self.evaluate(eval_params(state), eval_ds, step=step))
                elif step % self.checkpoint_every == 0:
                    self._save(step, state)
                if self._any_rank(guard.requested):
                    print("preemption requested — checkpointing and exiting", flush=True)
                    self._save(step, state)
                    return state
                if (self.deadline_margin is not None and step % 50 == 0
                        and self._any_rank(_deadline_time_left(self.deadline_margin) <= 0)):
                    print(f"round-deadline guard: stopping at step {step}", flush=True)
                    metrics = self.evaluate(eval_params(state), eval_ds, step=step) if eval_ds is not None else None
                    self._save(step, state, metrics)
                    return state
                if step >= self.max_steps:
                    break
        self._save(step, state)
        return state

    def _any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (every rank calls this alike)."""
        if not self.mesh.distributed:
            return flag
        import torch.distributed as dist

        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def _log(self, step: int, payload: dict) -> None:
        if self.main:
            self.logger.log(step, payload)

    def _save(self, step: int, state: TrainState, metrics: dict | None = None) -> None:
        if self.main:
            self.ckpt.save(step, state, metrics)

    # ------------------------------------------------------------------ eval

    def _calibration_stats(self, eval_ds, n_max: int) -> dict:
        """Pool the OrientationNorm statistics over the valid patches of the
        first ``calibrate_batches`` eval batches with the model's current
        parameters and attach them (``calibrate_norm_stats``), so that the
        metrics do not depend on how the eval batches are composed. {} when
        off, for an encoder without OrientationNorm layers, or when it fails."""
        if not (self.calibrate_eval and getattr(self.model, "has_norm_layers", False)):
            return {}
        try:
            calib = []
            host_rng = np.random.default_rng(self.seed + 2)
            for bi, nb in enumerate(batch_iterator(eval_ds, self.batch_size, n_max, host_rng, shuffle=False,
                                                   collate=self.adapter.collate)):
                if bi >= self.calibrate_batches or not hasattr(nb, "patches"):
                    break
                calib.append(np.asarray(nb.patches)[np.asarray(nb.node_mask)].astype(np.float32) / 255.0)
            return self.model.calibrate_norm_stats(calib) if calib else {}
        except Exception as e:  # calibration must never kill an eval pass
            print(f"norm-stats calibration skipped: {e}", flush=True)
            return {}

    def evaluate(self, params: dict[str, torch.Tensor], eval_ds, max_batches: int | None = None,
                 tag: str = "val", step: int = 0) -> dict:
        """Sample every eval batch and fold the model's metrics as the adapter
        does (per puzzle size, or per category and ``_AVG``); the model runs
        with ``params`` (and, with ``calibrate_eval``, statistics calibrated
        under them) and gets its own back.
        Other ranks than the main one return {} at once."""
        if not self.main:
            return {}
        n_max = self.adapter.max_nodes(eval_ds)
        agg = MeanMetrics()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        host_rng = np.random.default_rng(self.seed + 1)
        prev_stats = getattr(self.model, "norm_stats", None)
        with swapped_params(self.model, params):
            try:
                self._calibration_stats(eval_ds, n_max)
                for bi, nb in enumerate(batch_iterator(eval_ds, self.batch_size, n_max, host_rng, shuffle=False,
                                                       collate=self.adapter.collate)):
                    if max_batches is not None and bi >= max_batches:
                        break
                    db = self._device_batch(nb)
                    final = self.model.sample(db, gen).final
                    bm = {k: v.cpu().numpy() for k, v in self.model.metrics_from_final(final, db).items()}
                    self.adapter.fold_metrics(agg, bm, nb)
            finally:
                # training must never see frozen statistics
                if hasattr(self.model, "norm_stats"):
                    self.model.norm_stats = prev_stats
        metrics = agg.compute()
        self._log(step, {f"{tag}/{k}": v for k, v in metrics.items()})
        return metrics
