"""The held-out evaluation protocol of the JAX package's ``bench.py`` and
``scripts/tpu_train_device.py`` (``run_eval``), on a device-resident corpus
of one size or of several.

Slices of ``eval_n`` puzzles in order; each slice is gathered with its rows of
the rotation draw, sampled through ``Diffusion2D.sample``, scored with
``metrics_from_final`` and folded into per-size means. The slice size is part
of the protocol: "batch"-mode BatchNorm takes its statistics over every patch
of a call, so accuracy depends on how the puzzles are batched.
"""

from __future__ import annotations

import torch

from .device_data import DeviceMixedPuzzleData, DevicePuzzleData, gather_batch, gather_batch_mixed
from .metrics import MeanMetrics, update_puzzle_metrics


@torch.no_grad()
def heldout_eval(
    model,
    data: DevicePuzzleData | DeviceMixedPuzzleData,
    rot_k: torch.Tensor | None,
    eval_n: int = 32,
    on_slice=None,
) -> dict[str, float]:
    """``MeanMetrics.compute()`` over the whole corpus (``overall__piece_acc``,
    ``overall_acc``, ...). ``rot_k`` is the (S, N) rotation draw, or None for
    a model without rotation. The sampler's initial noise comes from torch's
    default generator; the flagship scales it by its ``noise_weight`` 0 and
    samples DDIM with eta 0, so, like bench.py's sample key, it changes
    nothing. ``on_slice(lo, batch, final)``, when given, sees each slice's
    batch and sampled poses (the recipe CLI draws reconstructions)."""
    dev = data.patches.device
    gather = gather_batch_mixed if isinstance(data, DeviceMixedPuzzleData) else gather_batch
    agg = MeanMetrics()
    for lo in range(0, data.n_samples, eval_n):
        idx = torch.arange(lo, min(lo + eval_n, data.n_samples), device=dev)
        batch = gather(data, idx, None if rot_k is None else rot_k[lo:lo + len(idx)])
        final = model.sample(batch).final
        if on_slice is not None:
            on_slice(lo, batch, final)
        metrics = {k: v.cpu().numpy() for k, v in model.metrics_from_final(final, batch).items()}
        update_puzzle_metrics(agg, metrics, batch.patches_dim.cpu().numpy(), batch.node_mask.cpu().numpy())
    return agg.compute()
