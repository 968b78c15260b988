"""Round-deadline guard — port of the JAX package's ``utils/deadline.py``.

A training run checks ``time_left(margin)`` every 50 steps and winds down
(final evaluation and checkpoint) once fewer than ``margin`` seconds remain
before the round's cutoff, so that the device is free when the round ends.

The cutoff, in order of precedence: the ``DIFFASSEMBLE_DEADLINE_EPOCH``
environment variable; an epoch in ``.deadline_epoch`` at the repository root,
unless it lies more than 10 minutes in the past; the next multiple of the
12-hour period after the newest ``PROGRESS.jsonl`` entry, anchored at its
``ts - wall_s``; now + 1 hour when that file cannot be read.
"""

from __future__ import annotations

import json
import math
import os
import time

_PROGRESS = os.path.join(os.path.dirname(__file__), "..", "..", "PROGRESS.jsonl")
_PERIOD = 43200.0


def round_deadline(progress_path: str | None = None) -> float:
    """Epoch timestamp of the current round's cutoff.

    An explicit ``progress_path`` bypasses both overrides. The file is read
    anew on each call, so a restart that moves the anchor (which only ever
    extends the deadline) takes effect at once."""
    if progress_path is None:
        env = os.environ.get("DIFFASSEMBLE_DEADLINE_EPOCH")
        if env:
            try:
                return float(env)
            except ValueError:
                pass
        # a stale file (an epoch well in the past, left by an earlier short
        # window) is ignored: otherwise time_left() would stay negative forever
        try:
            with open(os.path.join(os.path.dirname(_PROGRESS), ".deadline_epoch")) as f:
                epoch = float(f.read().strip())
            if epoch > time.time() - 600.0:
                return epoch
        except (OSError, ValueError):
            pass
    path = progress_path or _PROGRESS
    try:
        last = None
        with open(path) as f:
            for ln in f:
                if ln.strip():
                    last = ln
        rec = json.loads(last)
        anchor = float(rec["ts"]) - float(rec["wall_s"])
        k = max(1, math.ceil(float(rec["wall_s"]) / _PERIOD))
        return anchor + k * _PERIOD
    except (OSError, TypeError, ValueError, KeyError):
        return time.time() + 3600.0


def time_left(margin: float = 0.0, progress_path: str | None = None) -> float:
    """Seconds until (deadline − margin); negative means stop now."""
    return round_deadline(progress_path) - margin - time.time()
