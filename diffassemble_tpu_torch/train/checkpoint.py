"""Checkpointing and config serialization — the torch-native counterpart of the
JAX package's ``train/checkpoint.py``, in a format of the port's own; the
JAX package's checkpoints are not read here (that bridge is ROADMAP Queue 1
item 8).

Each checkpoint is ``<directory>/<step>/state.pt`` (``torch.save`` of the
parameters, the optimizer state, the step, the generator's state and the
EMA) beside ``metrics.json``; the model config is ``<directory>/config.json``.
The manager keeps the top-k checkpoints by a monitored metric plus the
latest. Restoring fills the template's parameters in place and returns a new
state.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
from pathlib import Path
from typing import Any

import torch

from .train_state import TrainState

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


def _steps(root: Path) -> list[int]:
    return sorted(int(p.name) for p in root.iterdir() if p.name.isdigit() and (p / STATE_FILE).is_file())


def _restore_into(path: Path, template: TrainState) -> TrainState:
    """Load ``path`` and fill ``template``'s parameters (in place), optimizer
    state, step, generator and EMA. An EMA saved without one in the template
    is put on the state; a template with EMA and a checkpoint without one
    seeds the average from the restored parameters."""
    device = next(iter(template.params.values())).device
    saved = torch.load(path, map_location=device, weights_only=True)
    if saved["params"].keys() != template.params.keys():
        raise ValueError(f"checkpoint {path} holds other parameters than the model")
    with torch.no_grad():
        for k, p in template.params.items():
            p.copy_(saved["params"][k])
    template.generator.set_state(saved["generator"].cpu())
    ema = saved.get("ema_params")
    if ema is None and template.ema_params is not None:
        ema = {k: p.detach().clone() for k, p in template.params.items()}
    return TrainState(template.params, saved["opt_state"], int(saved["step"]), template.generator, ema)


class CheckpointManager:
    def __init__(self, directory: str | Path, monitor: str = "overall_acc", mode: str = "max",
                 keep_top_k: int = 2):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.keep_top_k = keep_top_k

    def save_config(self, config: Any) -> None:
        cfg = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else dict(config)
        (self.directory / "config.json").write_text(json.dumps(cfg, indent=2))

    def load_config(self) -> dict:
        return json.loads((self.directory / "config.json").read_text())

    def _metrics(self, step: int) -> dict:
        path = self.directory / str(step) / METRICS_FILE
        return json.loads(path.read_text()) if path.is_file() else {}

    def save(self, step: int, state: TrainState, metrics: dict[str, float] | None = None) -> None:
        """Save ``state`` as step ``step``; a step already saved is kept as it is."""
        out = self.directory / str(step)
        if (out / STATE_FILE).is_file():
            return
        tmp = self.directory / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save({
            "params": {k: p.detach() for k, p in state.params.items()},
            "opt_state": state.opt_state,
            "step": state.step,
            "generator": state.generator.get_state(),
            "ema_params": state.ema_params,
        }, tmp / STATE_FILE)
        (tmp / METRICS_FILE).write_text(json.dumps({k: float(v) for k, v in (metrics or {}).items()}))
        shutil.rmtree(out, ignore_errors=True)
        tmp.rename(out)
        self._prune()

    def _prune(self) -> None:
        """Keep the latest step and the top-k steps by the monitored metric."""
        steps = _steps(self.directory)
        keep = set(steps[-1:])
        if self.monitor:
            keep.update(self._ranked(steps)[: self.keep_top_k])
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.directory / str(s))

    def _ranked(self, steps: list[int]) -> list[int]:
        """Steps with the monitored metric, best first."""
        scored = [(self._metrics(s).get(self.monitor), s) for s in steps]
        scored = [(v, s) for v, s in scored if v is not None and math.isfinite(v)]
        scored.sort(key=lambda vs: vs[0], reverse=self.mode == "max")
        return [s for _, s in scored]

    def restore(self, state_template: TrainState, step: int | None = None) -> TrainState | None:
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return _restore_into(self.directory / str(step) / STATE_FILE, state_template)

    def latest_step(self) -> int | None:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def best_step(self) -> int | None:
        ranked = self._ranked(_steps(self.directory)) if self.monitor else []
        return ranked[0] if ranked else None


def load_config_near(path: str | Path) -> dict:
    """The config.json stored next to an explicit checkpoint path (run dir,
    checkpoints root, or a single step dir)."""
    p = Path(path).absolute()
    for cand in (p / "checkpoints" / "config.json", p / "config.json", p.parent / "config.json"):
        if cand.is_file():
            return json.loads(cand.read_text())
    raise FileNotFoundError(f"no config.json near checkpoint path {p}")


def restore_explicit(path: str | Path, state_template: TrainState) -> TrainState:
    """Restore from an explicit checkpoint path: a run dir (holding
    ``checkpoints/``), a checkpoints root (the latest step is used) or one
    numbered step dir. Raises FileNotFoundError rather than falling back to
    fresh weights."""
    p = Path(path).absolute()
    if not p.exists():
        raise FileNotFoundError(f"checkpoint path does not exist: {p}")
    if (p / "checkpoints").is_dir():
        p = p / "checkpoints"
    if not p.name.isdigit():
        steps = _steps(p)
        if not steps:
            raise FileNotFoundError(f"no checkpoint steps under {p}")
        p = p / str(steps[-1])
    if not (p / STATE_FILE).is_file():
        raise FileNotFoundError(f"no {STATE_FILE} in {p}")
    return _restore_into(p / STATE_FILE, state_template)
