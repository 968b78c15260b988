"""Profiling hooks — port of the JAX package's ``utils/profiling.py``.

- ``trace(dir)``: a ``torch.profiler`` trace of everything inside (host and,
  with a card, device activity), written into ``dir`` as a Chrome trace;
- ``annotate(name)``: a named region in that trace
  (``torch.profiler.record_function``);
- ``timed(fn)``: the best wall-clock time of a few calls, each ended by a
  synchronize of the device its result lives on.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str = "runs/trace"):
    """Profile the enclosed computation; the trace lands in
    ``log_dir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region that shows in the profiler's timeline."""
    return torch.profiler.record_function(name)


def _synchronize(result) -> None:
    """Wait for every CUDA device that a tensor in ``result`` (a tensor, or a
    tuple, list or dict of them, nested) lives on."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)


def timed(fn: Callable, *args, iters: int = 3, warmup: int = 1, **kwargs):
    """(best seconds, last result) over ``iters`` calls after ``warmup``."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        _synchronize(result)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _synchronize(result)
        best = min(best, time.perf_counter() - t0)
    return best, result
