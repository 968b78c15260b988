"""Metric aggregation keyed per puzzle size or category — port of the JAX
package's ``train/metrics.py`` (numpy only).

2D: ``{(H, W)}_acc``, ``{(H, W)}__piece_acc``, ``{(H, W)}_nImages`` plus
``overall_*`` roll-ups; 3D: ``rmse_t_{cat}``, ``rmse_r_{cat}``,
``gd_r_{cat}``, ``part_acc_{cat}`` plus ``_AVG``. Device code emits
per-sample values; this host-side accumulator does the keyed running means.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class MeanMetrics:
    """Running means/sums keyed by string, mirroring torchmetrics semantics."""

    def __init__(self):
        self._sum = defaultdict(float)
        self._count = defaultdict(int)
        self._totals = defaultdict(float)

    def update_mean(self, key: str, values, weights=None):
        v = np.atleast_1d(np.asarray(values, dtype=np.float64))
        w = np.ones_like(v) if weights is None else np.atleast_1d(np.asarray(weights, dtype=np.float64))
        self._sum[key] += float((v * w).sum())
        self._count[key] += float(w.sum())

    def update_sum(self, key: str, values):
        self._totals[key] += float(np.asarray(values, dtype=np.float64).sum())

    def compute(self) -> dict[str, float]:
        out = {k: self._sum[k] / max(self._count[k], 1e-9) for k in self._sum}
        out.update({k: v for k, v in self._totals.items()})
        return out

    def reset(self):
        self._sum.clear()
        self._count.clear()
        self._totals.clear()


def update_puzzle_metrics(
    metrics: MeanMetrics,
    batch_metrics: dict,
    patches_dim: np.ndarray,
    node_mask: np.ndarray,
) -> None:
    """Fold one eval batch into per-size + overall metrics (2D).

    batch_metrics: device dict from Diffusion2D.metrics_from_final —
    piece_acc (B,), puzzle_correct (B,), n_valid (B,).
    """
    piece_acc = np.asarray(batch_metrics["piece_acc"])
    correct = np.asarray(batch_metrics["puzzle_correct"])
    dims = np.asarray(patches_dim)
    present = np.asarray(node_mask).any(-1)
    for i in range(len(piece_acc)):
        if not present[i]:
            continue
        key = f"({dims[i][0]}, {dims[i][1]})"
        metrics.update_mean(f"{key}_acc", correct[i])
        metrics.update_mean(f"{key}__piece_acc", piece_acc[i])
        metrics.update_sum(f"{key}_nImages", 1)
        metrics.update_mean("overall_acc", correct[i])
        metrics.update_mean("overall__piece_acc", piece_acc[i])
        metrics.update_sum("overall_nImages", 1)



def update_fragment_metrics(
    metrics: MeanMetrics,
    batch_metrics: dict,
    categories: np.ndarray,
    category_names: list[str],
) -> None:
    """Fold one 3D eval batch into per-category + AVG metrics."""
    for name in ("rmse_t", "rmse_r", "gd_r", "part_acc"):
        vals = np.asarray(batch_metrics[name])
        cats = np.asarray(categories)
        for i in range(len(vals)):
            cat = category_names[cats[i]] if cats[i] < len(category_names) else str(cats[i])
            metrics.update_mean(f"{name}_{cat}", vals[i])
            metrics.update_mean(f"{name}_AVG", vals[i])
