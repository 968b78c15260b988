"""The held-out evaluation protocols of the JAX package's 2D scripts, on a
device-resident corpus of one size or of several.

``heldout_eval`` is the loop of ``bench.py``, ``scripts/tpu_train_device.py``
(``run_eval``) and ``scripts/tpu_train_variants.py`` (``run_eval``): slices of
``eval_n`` puzzles in order; each slice is gathered with its rows of the
rotation draw, sampled through the model's ``sample``, scored with
``metrics_from_final`` and folded into per-size means. The slice size is part
of the protocol: "batch"-mode BatchNorm and OrientationNorm take their
statistics over every patch of a call, so accuracy depends on how the puzzles
are batched.

The trained checkpoints beside the flagship are committed converted
(``ASSETS``: the params of the JAX package's ``weights/<name>`` at one step,
its config, its protocol's arguments, the JAX rotation draw of each slice,
the expander where the protocol has one, and the JAX package's own CPU bf16
metrics on the protocol). ``protocol_corpus`` builds a protocol's held-out
corpus, ``evaluate_protocol`` evaluates a model on it, ``run_protocol`` an
asset under its own protocol:

    python -m diffassemble_tpu_torch.train.heldout --asset diffusion2d_discrete_rot6 [--device cpu]

- ``diffusion2d_rot_ms`` (``tpu_train_device``): sizes 6/8/10/12 padded to
  144 pieces, fully connected, eval images from seed + 1000, calls of 16;
  its sampler is deterministic (DDIM, no initial noise). ``cli/train_device.py
  --evaluate_npz`` runs ``evaluate_protocol`` with the protocol of its flags.
- ``diffusion2d_discrete_rot6`` (``tpu_train_variants``): 6×6, the 60%
  expander of ``build_device_data(..., seed=0)`` (committed: ARPACK's start
  vector leaves the seed a choice of five graphs), 64 images from seed 1000,
  calls of 32; the sampler draws Gumbel noise from a ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from .. import convert
from ..data.datasets import SyntheticImages
from .device_data import (
    DeviceMixedPuzzleData,
    DevicePuzzleData,
    build_device_data,
    build_device_data_mixed,
    gather_batch,
    gather_batch_mixed,
    size_topologies,
)
from .metrics import MeanMetrics, update_puzzle_metrics

_ASSET_DIR = Path(__file__).resolve().parents[1] / "assets"
ASSETS = {
    "diffusion2d_rot_ms": _ASSET_DIR / "diffusion2d_rot_ms_7000.npz",
    "diffusion2d_discrete_rot6": _ASSET_DIR / "diffusion2d_discrete_rot6_6000.npz",
}
SAMPLE_SEED = 7  # the generator of a stochastic sampler (the scripts' sample key is PRNGKey(7))


@torch.no_grad()
def heldout_eval(
    model,
    data: DevicePuzzleData | DeviceMixedPuzzleData,
    rot_k: torch.Tensor | None,
    eval_n: int = 32,
    on_slice=None,
    generator: torch.Generator | None = None,
) -> dict[str, float]:
    """``MeanMetrics.compute()`` over the whole corpus (``overall__piece_acc``,
    ``overall_acc``, ...). ``rot_k`` is the (S, N) rotation draw, or None for
    a model without rotation. The sampler draws from ``generator`` (torch's
    default one when None); the flagship scales its initial noise by its
    ``noise_weight`` 0 and samples DDIM with eta 0, so, like bench.py's sample
    key, it changes nothing there. ``on_slice(lo, batch, final)``, when given,
    sees each slice's batch and sampled poses (the recipe CLI draws
    reconstructions)."""
    dev = data.patches.device
    gather = gather_batch_mixed if isinstance(data, DeviceMixedPuzzleData) else gather_batch
    agg = MeanMetrics()
    for lo in range(0, data.n_samples, eval_n):
        idx = torch.arange(lo, min(lo + eval_n, data.n_samples), device=dev)
        batch = gather(data, idx, None if rot_k is None else rot_k[lo:lo + len(idx)])
        final = model.sample(batch, generator).final
        if on_slice is not None:
            on_slice(lo, batch, final)
        metrics = {k: v.cpu().numpy() for k, v in model.metrics_from_final(final, batch).items()}
        update_puzzle_metrics(agg, metrics, batch.patches_dim.cpu().numpy(), batch.node_mask.cpu().numpy())
    return agg.compute()


def protocol_corpus(protocol: dict, device, eval_n: int | None = None, adj: np.ndarray | None = None):
    """The protocol's held-out corpus on ``device`` (its first ``eval_n``
    puzzles): ``SyntheticImages`` from seed + 1000 with the protocol's image
    knobs, over ``adj`` (the committed expander) or the topology of its
    degree (fully connected for -1)."""
    p = protocol
    n = p["eval_n"] if eval_n is None else eval_n
    kw = dict(n=p["eval_n"], seed=p["seed"] + 1000, cache=False, canonical=p["canonical"],
              hf_detail=p["hf_detail"], style=p["style"])
    sizes = [(s, s) for s in p["hw"]]
    if len(sizes) > 1:
        if adj is not None:
            raise ValueError("a mixed corpus takes its topologies from its degree")
        sources = {}

        def factory(shw, i):
            if shw not in sources:
                sources[shw] = SyntheticImages(shw, **kw)
            return sources[shw][i]

        return build_device_data_mixed(factory, sizes, n, device=device,
                                       topologies=size_topologies(sizes, p["degree"], p["seed"]))
    hw = sizes[0]
    topology = adj if adj is not None else size_topologies(sizes, p["degree"], p["seed"])[hw]
    return build_device_data(SyntheticImages((hw[0] * 32, hw[1] * 32), **kw), hw, n, device=device,
                             topology=topology)


def load_asset(name: str, device, compute_dtype: str | None = None):
    """(model with the asset's params, its config, its protocol, the asset's
    other arrays) of ``ASSETS[name]``, in ``compute_dtype`` (default: the
    checkpoint's)."""
    from ..models import (Diffusion2D, Diffusion2DConfig, DiscreteDiffusion2D, DiscreteDiffusion2DConfig,
                          DiscreteDiffusion2DRot)

    state, extras = convert.load_jax_npz(ASSETS[name])
    base = json.loads(str(extras["config"]))
    if "n_classes" in base:
        cfg = DiscreteDiffusion2DConfig(**base)
        cls = DiscreteDiffusion2DRot if cfg.rotation else DiscreteDiffusion2D
    else:
        cfg, cls = Diffusion2DConfig(**base), Diffusion2D
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype or cfg.compute_dtype, encoder_init="")
    model = cls(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model, cfg, json.loads(str(extras["protocol"])), extras


def asset_adj(extras: dict) -> np.ndarray | None:
    """The committed expander of an asset, or None (a fully connected protocol)."""
    if "heldout_adj_bits" not in extras:
        return None
    bits = extras["heldout_adj_bits"]
    n = int(round(np.sqrt(bits.size * 8)))
    return np.unpackbits(bits)[: n * n].reshape(n, n).astype(bool)


def asset_protocol(name: str) -> tuple[dict, dict]:
    """(protocol, the asset's arrays but the params) of ``ASSETS[name]``."""
    with np.load(ASSETS[name]) as z:
        extras = {k: z[k] for k in z.files if "/" not in k}
    return json.loads(str(extras["protocol"])), extras


def evaluate_protocol(model, protocol: dict, rot_k: np.ndarray | None, device, eval_n: int | None = None,
                      adj: np.ndarray | None = None) -> dict[str, float]:
    """``heldout_eval`` of ``model`` over the protocol's corpus (its first
    ``eval_n`` puzzles, over ``adj`` where given) in calls of its
    ``eval_batch``, with the rows of the (S, N) rotation draw ``rot_k`` (None
    for a model without rotation), sampling from ``SAMPLE_SEED``."""
    data = protocol_corpus(protocol, device, eval_n, adj)
    if rot_k is not None:
        rot_k = torch.as_tensor(rot_k[: data.n_samples].astype(np.int64), device=device)
    generator = torch.Generator(device=device).manual_seed(SAMPLE_SEED)
    return heldout_eval(model, data, rot_k, eval_n=protocol["eval_batch"], generator=generator)


def run_protocol(name: str, device="cuda", compute_dtype: str | None = None, eval_n: int | None = None) -> dict:
    """Asset ``name`` under its protocol on ``device``: the metrics of
    ``heldout_eval`` over the first ``eval_n`` puzzles (default: all; a
    whole number of the protocol's calls keeps its batching), with the JAX
    rotation draw, and the JAX package's CPU bf16 figures beside
    (``jax_cpu_bfloat16``, over all puzzles)."""
    device = torch.device(device)
    model, _, protocol, extras = load_asset(name, device, compute_dtype)
    metrics = evaluate_protocol(model, protocol, extras["heldout_rot_k"], device, eval_n, asset_adj(extras))
    return {**metrics, "jax_cpu_bfloat16": json.loads(str(extras["jax_cpu_bfloat16"]))}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--asset", default="diffusion2d_discrete_rot6", choices=sorted(ASSETS))
    ap.add_argument("--eval_n", type=int, default=None, help="the first puzzles only (default: all)")
    ap.add_argument("--compute_dtype", default=None, help="default: the checkpoint's (bfloat16)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_protocol(args.asset, args.device, args.compute_dtype, args.eval_n)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
