"""Training loop — port of the JAX package's ``train/trainer.py`` (the puzzle task).

- the train step of ``train_state.py`` on one device, batches moved from the
  host by a prefetch thread;
- a sanity evaluation before training, periodic evaluation (the sampler plus
  greedy-assignment metrics, folded per puzzle size) and checkpointing with
  top-k by a monitored metric, and resume from the latest checkpoint;
- metric logging to stdout and ``metrics.jsonl``;
- the dead-gradient tripwire.

Not ported: the device mesh (one device; DDP later), the preemption guard,
the round-deadline guard, reconstruction images (they need PIL) and the
OrientationNorm calibration (equivariant encoders only).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..data.batch import PuzzleBatch, collate_puzzles
from ..data.prefetch import prefetch
from .checkpoint import CheckpointManager
from .metrics import MeanMetrics, update_puzzle_metrics
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
        seed: int = 0,
        adapter: TaskAdapter | None = None,
        ema_decay: float | None = None,
        dead_grad_patience: int = 20,
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
        # top-k by overall_acc (max) plus the latest
        self.ckpt = CheckpointManager(self.run_dir / "checkpoints")
        self.ema_decay = ema_decay
        self.optimizer = model.make_optimizer()
        self.train_step = make_train_step(model.loss, self.optimizer, accumulate, ema_decay=ema_decay)
        # dead-gradient tripwire: grad_norm exactly 0 or non-finite gradients
        # for this many CONSECUTIVE steps aborts the run with a checkpoint
        # instead of stepping in place; 0/None disables it
        self.dead_grad_patience = dead_grad_patience

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
        state = self.new_state()
        restored = self.ckpt.restore(state)
        if restored is not None:
            state = restored
            print(f"resumed from step {state.step}", flush=True)
        self.ckpt.save_config(self.model.cfg)

        if eval_ds is not None:  # sanity eval of one batch before training
            self.evaluate(eval_params(state), eval_ds, max_batches=1, tag="sanity")

        step = state.step
        t_last = time.time()
        dead_streak = 0
        while step < self.max_steps:
            for nb in prefetch(batch_iterator(train_ds, self.batch_size, n_max, host_rng,
                                              collate=self.adapter.collate)):
                state, aux = self.train_step(state, self._device_batch(nb))
                step = state.step
                if self.dead_grad_patience:
                    dead = float(aux["grad_norm"]) == 0.0 or float(aux["grad_nonfinite"]) >= 1.0
                    dead_streak = dead_streak + 1 if dead else 0
                    if dead_streak >= self.dead_grad_patience:
                        print(f"DEAD-GRADIENT TRIPWIRE: grad_norm==0 or non-finite for {dead_streak} "
                              f"consecutive steps at step {step} — checkpointing and aborting "
                              "(non-retryable)", flush=True)
                        self.ckpt.save(step, state)
                        raise DeadGradientError(f"gradients dead for {dead_streak} steps at step {step}")
                if step % 50 == 0 or step == 1:
                    dt = time.time() - t_last
                    t_last = time.time()
                    self.logger.log(step, {**aux, "steps_per_s": 50 / max(dt, 1e-9)})
                if eval_ds is not None and step % self.eval_every == 0:
                    metrics = self.evaluate(eval_params(state), eval_ds, step=step)
                    self.ckpt.save(step, state, metrics)
                elif step % self.checkpoint_every == 0:
                    self.ckpt.save(step, state)
                if step >= self.max_steps:
                    break
        self.ckpt.save(step, state)
        return state

    # ------------------------------------------------------------------ eval

    def evaluate(self, params: dict[str, torch.Tensor], eval_ds, max_batches: int | None = None,
                 tag: str = "val", step: int = 0) -> dict:
        """Sample every eval batch and fold the greedy-assignment metrics per
        puzzle size; the model runs with ``params`` and gets its own back."""
        n_max = self.adapter.max_nodes(eval_ds)
        agg = MeanMetrics()
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        host_rng = np.random.default_rng(self.seed + 1)
        with swapped_params(self.model, params):
            for bi, nb in enumerate(batch_iterator(eval_ds, self.batch_size, n_max, host_rng, shuffle=False,
                                                   collate=self.adapter.collate)):
                if max_batches is not None and bi >= max_batches:
                    break
                db = self._device_batch(nb)
                final = self.model.sample(db, gen).final
                bm = {k: v.cpu().numpy() for k, v in self.model.metrics_from_final(final, db).items()}
                self.adapter.fold_metrics(agg, bm, nb)
        metrics = agg.compute()
        self.logger.log(step, {f"{tag}/{k}": v for k, v in metrics.items()})
        return metrics
