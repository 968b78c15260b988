"""Multi-process runtime and failure handling — port of the JAX package's
``parallel/distributed.py``.

- ``initialize()``: ``torch.distributed.init_process_group`` over NCCL on the
  card and gloo on the CPU, from the ``DIFFASSEMBLE_{COORDINATOR,
  NUM_PROCESSES,PROCESS_ID}`` variables (``scripts/launch_multihost.sh``) or
  torchrun's own (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``); a single process is a no-op. Each process
  drives one card, ``LOCAL_RANK``'s: the kernels launch on the current CUDA
  device.
- ``is_main_process()``: rank 0 (or no group), the one that logs and saves.
- ``PreemptionGuard``: SIGTERM/SIGINT set a flag, so that the training loop
  checkpoints and returns at the next step boundary; ``uninstall`` puts the
  earlier handlers back.
"""

from __future__ import annotations

import os
import signal
from typing import Callable

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str = "cuda",
) -> bool:
    """Join the run's process group; returns whether one is initialized.

    ``coordinator_address`` is host:port of rank 0. Unset arguments come from
    the environment; fewer than two processes, or a group already
    initialized, change nothing."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("DIFFASSEMBLE_COORDINATOR")
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(env.get("DIFFASSEMBLE_NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    if process_id is None:
        process_id = int(env.get("DIFFASSEMBLE_PROCESS_ID", env.get("RANK", "0")))
    if dist.is_initialized() or num_processes <= 1:
        return dist.is_initialized()
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes but no coordinator address "
                         "(DIFFASSEMBLE_COORDINATOR or MASTER_ADDR)")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        local = int(env.get("LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if on_card else "gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class PreemptionGuard:
    """Handlers for SIGTERM/SIGINT; training loops poll ``.requested`` and
    checkpoint and return at the next step boundary."""

    def __init__(self, on_preempt: Callable[[], None] | None = None):
        self.requested = False
        self._on_preempt = on_preempt
        self._installed = False
        self._previous = {}

    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self

        def handler(signum, frame):
            self.requested = True
            if self._on_preempt is not None:
                self._on_preempt()

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._previous[sig] = signal.signal(sig, handler)
            self._installed = True
        except ValueError:
            pass  # not in the main thread: polling only
        return self

    def uninstall(self) -> None:
        for sig, previous in self._previous.items():
            signal.signal(sig, previous)
        self._previous.clear()
        self._installed = False
