"""Shared inputs of the training parity tests (``test_torch_train*.py``):
numpy-seeded parameters in the JAX package's tree layout, a small puzzle
batch, the JAX loss's random draws, and the small flagship-shaped config."""

from pathlib import Path

import jax
import numpy as np
import torch

from diffassemble_tpu_torch.data import collate_puzzles, make_puzzle

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(steps=300, inference_ratio=100, mean_type="xstart", rotation=True, backbone="efficientnet_b0",
           architecture="exophormer", n_layers=2, virt_nodes=2, hidden_dim=32, heads=4, aux_loss_weight=0.1,
           classifier_free_prob=0.5, compute_dtype="float32")


def seeded_params(module, seed, *inputs):
    """Numpy parameters of the flax module's shapes: kernels at 1/√fan_in,
    scales near 1, biases and tables small but non-zero."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def small_batch(seed=7, b=2):
    rng = np.random.default_rng(seed)
    samples = [make_puzzle(rng.random((96, 96, 3)).astype(np.float32), 3, 3, 32, rotation=True, rng=rng)
               for _ in range(b)]
    batch = collate_puzzles(samples, 9)
    node_mask = batch.node_mask.copy()
    node_mask[-1, -2:] = False  # padded pieces in the last puzzle
    adj = batch.adj & node_mask[:, :, None] & node_mask[:, None, :]
    return batch._replace(adj=adj, node_mask=node_mask)


def jax_draws(rng, b, shape, steps, prob):
    """The JAX loss's draws from ``rng``, as numpy."""
    k_t, k_noise, k_cf = jax.random.split(rng, 3)
    return dict(t_graph=np.asarray(jax.random.randint(k_t, (b,), 0, steps)),
                noise=np.asarray(jax.random.normal(k_noise, shape)),
                cf_keep=np.asarray(jax.random.uniform(k_cf, (b, 1, 1)) >= prob))


def torch_draws(d):
    """The draws as tensors for the port's loss."""
    return {k: torch.tensor(v) for k, v in d.items()}


def assert_same_step(got, want, before, grad, unfactored: bool, grad_tol, rel: float, name: str = ""):
    """Parameters ``got`` and ``want`` after one Adafactor step from ``before``
    agree within ``rel`` of the largest step plus 1e-6 relative.

    Adafactor's first update of an unfactored parameter is lr·scale·g/√(g²+ε),
    i.e. its sign: where |g| is within ``grad_tol`` of 0 (rounding noise in
    one computation or the other), the sign, or whether the step is taken at
    all, is not determined, and the step there is only held to the
    parameter's largest step."""
    d_got, d_want = got - before, want - before
    step = float(d_want.abs().max())
    tol = rel * step + 1e-6 * want.abs()
    sure = grad.abs() > grad_tol if unfactored else torch.ones_like(grad, dtype=torch.bool)
    assert bool(((d_got - d_want).abs() <= tol)[sure].all()), name
    assert bool((d_got.abs() <= step + tol)[~sure].all()), name
