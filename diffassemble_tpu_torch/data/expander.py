"""Random d-regular expander graph topologies as boolean attention masks.

Port of the JAX package's ``data/expander.py``: d-regular random graphs
built from permutation + rolls, retried until the second-smallest Laplacian
eigenvalue clears the bound ``d − 2√(d−1) − 0.1``, with a fully-connected
fallback for ≤10 nodes and percent-degree strings ("10%"). The output is an
(N, N) boolean adjacency mask, the attention-mask currency of the package.
``cached_expander_mask`` (one fixed topology per size, the ``unique_graph``
mode) and ``random_dropout_mask`` (random edge subsampling) complete it.
Runs host-side (numpy/scipy); the same ``rng`` gives the same mask as the JAX
package's copy.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def parse_degree(degree: int | str, num_nodes: int) -> int:
    """Percent strings ("60%") → absolute degree."""
    if isinstance(degree, str):
        if not degree.endswith("%"):
            raise ValueError(f"bad degree spec {degree!r}")
        return round(int(degree[:-1]) * (num_nodes - 1) / 100)
    return int(degree)


def _random_regular_edges(
    num_nodes: int, degree: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Permutation-and-roll d-regular graph."""
    if degree == 0:
        return np.array([], dtype=np.int64), np.array([], dtype=np.int64)
    if (num_nodes * degree) % 2 != 0:
        degree += 1  # keep nodes*degree even rather than erroring mid-pipeline
    nodes = rng.permutation(np.arange(num_nodes))
    num_reps = degree // 2
    ns = np.hstack([np.roll(nodes, i + 1) for i in range(num_reps)]) if num_reps else np.array([], dtype=np.int64)
    senders = np.tile(nodes, num_reps)
    if degree % 2 == 1:
        senders = np.concatenate([senders, nodes[: num_nodes // 2]])
        ns = np.concatenate([ns, nodes[num_nodes // 2 :]])
    return (
        np.concatenate([senders, ns]),
        np.concatenate([ns, senders]),
    )


def _fiedler_value(senders: np.ndarray, receivers: np.ndarray, num_nodes: int) -> float:
    """Second-smallest eigenvalue of the (unnormalized) graph Laplacian."""
    from scipy.sparse import coo_matrix, diags
    from scipy.sparse.linalg import eigsh

    w = np.ones(len(senders))
    a = coo_matrix((w, (senders, receivers)), shape=(num_nodes, num_nodes))
    a = a.minimum(1.0).tocsr()  # dedupe parallel edges
    deg = np.asarray(a.sum(axis=1)).ravel()
    lap = diags(deg) - a
    vals = eigsh(lap, k=2, which="SM", return_eigenvectors=False)
    return float(np.sort(vals)[1])


def expander_mask(
    num_nodes: int,
    degree: int | str,
    rng: np.random.Generator | None = None,
    max_num_iters: int = 5,
    self_loops: bool = True,
) -> np.ndarray:
    """(N, N) boolean mask of a spectral-gap-checked random expander.

    Keeps the best-gap candidate over ≤ max_num_iters tries; ≤10 nodes fall
    back to fully connected.
    """
    if rng is None:
        rng = np.random.default_rng()
    deg = parse_degree(degree, num_nodes)
    mask = np.zeros((num_nodes, num_nodes), dtype=bool)

    if deg < 0 or num_nodes <= 10:
        mask[:] = True
    else:
        if num_nodes <= deg:
            deg = num_nodes - 1
        bound = max(0.0, deg - 2 * math.sqrt(max(deg - 1, 0)) - 0.1) if deg > 0 else 0.0
        best = (-1.0, None)
        for _ in range(max_num_iters):
            s, r = _random_regular_edges(num_nodes, deg, rng)
            gap = _fiedler_value(s, r, num_nodes) if len(s) else 0.0
            if gap > best[0]:
                best = (gap, (s, r))
            if gap >= bound:
                break
        s, r = best[1]
        mask[s, r] = True
        mask |= mask.T  # symmetric
    if self_loops:
        np.fill_diagonal(mask, True)
    return mask


@lru_cache(maxsize=64)
def cached_expander_mask(num_nodes: int, degree_key: str, seed: int) -> np.ndarray:
    """One fixed topology per (size, degree) — the reference's `unique_graph`
    mode (puzzle_dataset.py:194-212).

    The returned array is marked read-only: lru_cache hands the same ndarray
    to every caller, so an in-place mutation would poison the cache."""
    rng = np.random.default_rng(seed)
    mask = expander_mask(num_nodes, degree_key if degree_key.endswith("%") else int(degree_key), rng)
    mask.setflags(write=False)
    return mask


def random_dropout_mask(
    num_nodes: int, keep_frac: float, rng: np.random.Generator
) -> np.ndarray:
    """Random edge subsampling of the dense graph — the reference's
    `random_dropout` alternative to expanders (puzzle_dataset.py:615-628)."""
    mask = rng.random((num_nodes, num_nodes)) < keep_frac
    mask |= mask.T
    np.fill_diagonal(mask, True)
    return mask
