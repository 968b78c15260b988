"""Weight bridge: the JAX package's parameter tree → this package's state_dict.

The input is the nested dict of numpy arrays that the JAX package's
``Diffusion2D.init`` (or a restored checkpoint's ``params``) holds, converted
to numpy by the caller, so this module needs no JAX:

    {"encoder": {...}, "denoiser": {...}}

``load_jax_npz`` reads such a tree from an npz with ``a/b/c`` keys, and any
other arrays stored beside it. Leaf rules: a Dense kernel (in, out) becomes a Linear weight (out, in); a conv
kernel HWIO becomes OIHW (a depthwise (kh, kw, 1, C) kernel becomes
(C, 1, kh, kw)); Embed tables, LayerNorm and BatchNorm2D scales become
``weight``; biases and the Exophormer's ``virt_embedding`` carry over. Module
names follow the port's (``Exophormer_0`` → ``gnn``, ``layer_3`` →
``layers.3``, ``blocks_2_1`` → ``blocks.2.1``, ...). The denoiser's
Dense→GELU→Dense heads are ``Sequential``s built inside its compact
method, so their layers sit at the denoiser's top level as ``Dense_0`` ...
in creation order: the position MLP, then ``final`` (or ``final_t`` and
``final_r`` with two heads).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .utils.params import load_params

_SEGMENT_RULES = (
    (re.compile(r"^(Exophormer|GraphTransformer)_0$"), "gnn"),
    (re.compile(r"^layer_(\d+)$"), r"layers.\1"),
    (re.compile(r"^blocks_(\d+)_(\d+)$"), r"blocks.\1.\2"),
    (re.compile(r"^Dense_0$"), "fc1"),
    (re.compile(r"^Dense_1$"), "fc2"),
)


def _rename(segment: str) -> str:
    for pattern, repl in _SEGMENT_RULES:
        if pattern.match(segment):
            return pattern.sub(repl, segment)
    return segment


def _leaf(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if arr.ndim == 2:  # Dense (in, out) → (out, in)
            return "weight", arr.T
        if arr.ndim == 4:  # conv HWIO → OIHW
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {arr.ndim}")
    if name in ("scale", "embedding"):
        return "weight", arr
    if name in ("bias", "virt_embedding"):
        return name, arr
    raise ValueError(f"unknown parameter leaf {name!r}")


def _flatten(tree: dict, prefix: tuple[str, ...] = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _denoiser_heads(denoiser: dict) -> dict:
    """Regroup the denoiser's top-level ``Dense_i`` into its named heads."""
    dense = sorted((k for k in denoiser if re.match(r"^Dense_\d+$", k)), key=lambda k: int(k[6:]))
    heads = {4: ("pos_mlp", "final"), 6: ("pos_mlp", "final_t", "final_r")}.get(len(dense))
    if heads is None:
        raise ValueError(f"unexpected denoiser Dense layers {dense}")
    out = {k: v for k, v in denoiser.items() if k not in dense}
    for i, head in enumerate(heads):
        out[head] = {"0": denoiser[dense[2 * i]], "2": denoiser[dense[2 * i + 1]]}
    return out


def load_jax_npz(path) -> tuple[dict[str, torch.Tensor], dict[str, np.ndarray]]:
    """An npz of a flattened parameter tree → (``Diffusion2D`` state_dict, extras).

    Keys with a ``/`` are ``a/b/c`` paths into the JAX package's tree
    (``encoder/...``, ``denoiser/...``); they are rebuilt into the nested tree
    and converted by ``convert_params``. Every other key is returned as it is
    in ``extras``."""
    tree = load_params(path)
    extras = {k: tree.pop(k) for k in list(tree) if not isinstance(tree[k], dict)}
    return convert_params(tree), extras


def convert_params(params: dict) -> dict[str, torch.Tensor]:
    """Nested numpy parameter dict → ``Diffusion2D`` state_dict (float32).

    Each top-level key becomes the state_dict prefix (``encoder.``,
    ``denoiser.``), so a single module's subtree converts on its own too."""
    if "denoiser" in params:
        params = {**params, "denoiser": _denoiser_heads(params["denoiser"])}
    out = {}
    for path, arr in _flatten(params):
        name, value = _leaf(path[-1], np.asarray(arr, dtype=np.float32))
        key = ".".join([_rename(s) for s in path[:-1]] + [name])
        out[key] = torch.from_numpy(np.array(value, order="C"))
    return out
