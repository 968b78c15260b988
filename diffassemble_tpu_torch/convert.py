"""Weight bridge: the JAX package's parameter tree → this package's state_dict.

The input is the nested dict of numpy arrays that the JAX package's
``Diffusion2D.init`` or ``Diffusion3D.init`` (or a restored checkpoint's
``params``) holds, converted to numpy by the caller, so this module needs no
JAX:

    {"encoder": {...}, "denoiser": {...}}               the 2D models
    {"encoder": {...}, "relpose": {...}, "denoiser": {...}}  the 3D model

``load_jax_npz`` reads such a tree from an npz with ``a/b/c`` keys, and any
other arrays stored beside it. Leaf rules: a Dense kernel (in, out) becomes a
Linear weight (out, in), and so does a VN linear's bias-free channel mix (C,
D); a conv kernel HWIO becomes OIHW (a depthwise (kh, kw, 1, C) kernel
becomes (C, 1, kh, kw)), but a group convolution's (``GroupConvP4_i`` ...)
keeps the JAX shape, as ``nn/visual.py`` holds it; Embed tables,
OrientationNorm, LayerNorm, BatchNorm2D and VNNorm
scales become ``weight``; biases, the Exophormer's ``virt_embedding`` and the
relative-pose head's raw projections ``U`` and ``V`` (C, k) carry over as
they are. Module names follow the port's (``Exophormer_0`` or
``DualStreamGraphTransformer_0`` → ``gnn``, ``layer_3`` → ``layers.3``,
``blocks_2_1`` → ``blocks.2.1``, ``VNLinearLeakyReLU_4`` → ``layers.4``,
``VNNorm_0`` → ``norm``, ``VNStdFeature_0`` → ``std_feature``,
``PointMLP_1`` → ``mlps.1``, ``TNet_0`` → ``tnets.0``, ``relpose`` →
``rel_head``, ...); some renames hold under one parent only (``Dense_0`` is
``fc1``, the fusion MLP's, but ``dense.0`` in a ``PointMLP_i`` or ``TNet_i``
and ``out`` directly under ``encoder``, the VN-PointNet's projection, and
``VNLinear_0`` is ``frame`` in ``VNStdFeature_0`` but ``vn_out`` directly
under ``encoder``; the equivariant ResNet's ``GroupConvZ2_0`` and
``OrientationNorm_0`` directly under ``encoder`` are ``stem`` and
``stem_norm``, and in an ``EquivariantBasicBlock_k`` or
``EquivariantBottleneck_k`` (→ ``blocks.k``) ``GroupConvP4_i`` and
``OrientationNorm_i`` are ``conv{i+1}`` and ``norm{i+1}`` but the last of a
block with a projected shortcut, ``shortcut`` and ``shortcut_norm``). The
denoiser's Dense→GELU→Dense heads are
``Sequential``s built inside its compact method, so their layers sit at the
denoiser's top level as ``Dense_0`` ... in creation order: the position MLP,
then ``final`` (or ``final_t`` and ``final_r`` with two heads) in the 2D
denoiser, ``final_pos`` (and ``final_rot``) in the discrete one, which has
``pos_emb`` in place of a position MLP. The caller names the heads of any other denoiser: the 3D one's
are ``HEADS_3D``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .utils.params import load_params

# (the JAX segment's parent, or None for any parent; the segment; its port name), first match wins
_SEGMENT_RULES = tuple((parent and re.compile(parent), re.compile(seg), repl) for parent, seg, repl in (
    (r"^(PointMLP|TNet)_\d+$", r"^Dense_(\d+)$", r"dense.\1"),
    (r"^PointMLP_\d+$", r"^LayerNorm_(\d+)$", r"norms.\1"),
    (r"^VNStdFeature_0$", r"^VNLinear_0$", "frame"),
    (r"^encoder$", r"^VNLinear_0$", "vn_out"),  # VNPointNetEncoder's last VN layer
    (r"^encoder$", r"^Dense_0$", "out"),  # and its projection
    (r"^corr$", r"^LayerNorm_0$", "norm"),  # CorrespondencePairs' descriptor norm
    (None, r"^(Exophormer|GraphTransformer|DualStreamGraphTransformer)_0$", "gnn"),
    (None, r"^layer_(\d+)$", r"layers.\1"),
    (None, r"^blocks_(\d+)_(\d+)$", r"blocks.\1.\2"),
    (None, r"^Dense_0$", "fc1"),
    (None, r"^Dense_1$", "fc2"),
    (None, r"^VNLinearLeakyReLU_(\d+)$", r"layers.\1"),
    (None, r"^VNNorm_0$", "norm"),
    (None, r"^VNStdFeature_0$", "std_feature"),
    (None, r"^PointMLP_(\d+)$", r"mlps.\1"),
    (None, r"^TNet_(\d+)$", r"tnets.\1"),
    (None, r"^relpose$", "rel_head"),
    # the equivariant ResNets: the stem under the encoder, the blocks' convs and norms by creation order
    (r"^encoder$", r"^GroupConvZ2_0$", "stem"),
    (r"^encoder$", r"^OrientationNorm_0$", "stem_norm"),
    (None, r"^Equivariant(BasicBlock|Bottleneck)_(\d+)$", r"blocks.\2"),
    (r"^EquivariantBasicBlock_\d+$", r"^GroupConvP4_2$", "shortcut"),
    (r"^EquivariantBasicBlock_\d+$", r"^OrientationNorm_2$", "shortcut_norm"),
    (r"^EquivariantBottleneck_\d+$", r"^GroupConvP4_3$", "shortcut"),
    (r"^EquivariantBottleneck_\d+$", r"^OrientationNorm_3$", "shortcut_norm"),
    (r"^Equivariant(BasicBlock|Bottleneck)_\d+$", r"^GroupConvP4_(\d)$", lambda m: f"conv{int(m[1]) + 1}"),
    (r"^Equivariant(BasicBlock|Bottleneck)_\d+$", r"^OrientationNorm_(\d)$", lambda m: f"norm{int(m[1]) + 1}"),
))
_GROUP_CONV = re.compile(r"^GroupConv(Z2|P4|Z2M|P4M)_\d+$")
# the 2D denoiser's heads, by its number of Dense layers; the discrete one's (it embeds x_t)
_HEADS_2D = {4: ("pos_mlp", "final"), 6: ("pos_mlp", "final_t", "final_r")}
_HEADS_2D_DISCRETE = ("final_pos", "final_rot")
HEADS_3D = ("pos_mlp", "mlp_t", "mlp_r")


def _rename(segment: str, parent: str | None = None) -> str:
    for parent_pattern, pattern, repl in _SEGMENT_RULES:
        if pattern.match(segment) and (parent_pattern is None or (parent is not None and parent_pattern.match(parent))):
            return pattern.sub(repl, segment)
    return segment


def _leaf(name: str, arr: np.ndarray, parent: str | None = None) -> tuple[str, np.ndarray]:
    if name == "kernel" and parent is not None and _GROUP_CONV.match(parent):
        return name, arr  # a group convolution keeps the JAX layout (nn/visual.py)
    if name == "kernel":
        if arr.ndim == 2:  # Dense (in, out) → (out, in)
            return "weight", arr.T
        if arr.ndim == 4:  # conv HWIO → OIHW
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {arr.ndim}")
    if name in ("scale", "embedding"):
        return "weight", arr
    if name in ("bias", "virt_embedding", "U", "V"):
        return name, arr
    raise ValueError(f"unknown parameter leaf {name!r}")


def _flatten(tree: dict, prefix: tuple[str, ...] = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _denoiser_heads(denoiser: dict, heads: tuple[str, ...] | None) -> dict:
    """Regroup the denoiser's top-level ``Dense_i`` into its named heads
    (``heads``, or the 2D denoiser's when None)."""
    dense = sorted((k for k in denoiser if re.match(r"^Dense_\d+$", k)), key=lambda k: int(k[6:]))
    if heads is None:
        heads = _HEADS_2D_DISCRETE[:len(dense) // 2] if "pos_emb" in denoiser else _HEADS_2D.get(len(dense))
    if heads is None or len(dense) != 2 * len(heads):
        raise ValueError(f"unexpected denoiser Dense layers {dense} for heads {heads}")
    out = {k: v for k, v in denoiser.items() if k not in dense}
    for i, head in enumerate(heads):
        out[head] = {"0": denoiser[dense[2 * i]], "2": denoiser[dense[2 * i + 1]]}
    return out


def load_jax_npz(path, heads: tuple[str, ...] | None = None) -> tuple[dict[str, torch.Tensor], dict[str, np.ndarray]]:
    """An npz of a flattened parameter tree → (``Diffusion2D`` or ``Diffusion3D`` state_dict, extras).

    Keys with a ``/`` are ``a/b/c`` paths into the JAX package's tree
    (``encoder/...``, ``denoiser/...``); they are rebuilt into the nested tree
    and converted by ``convert_params`` with the denoiser's ``heads``. A leaf
    named in the extra ``bfloat16_leaves`` is stored as bf16 bits (uint16)
    and widened to f32. Every other key is returned as it is in ``extras``."""
    tree = load_params(path)
    extras = {k: tree.pop(k) for k in list(tree) if not isinstance(tree[k], dict)}
    for key in extras.get("bfloat16_leaves", ()):
        *parents, leaf = str(key).split("/")
        node = tree
        for p in parents:
            node = node[p]
        node[leaf] = bf16_to_f32(node[leaf])
    return convert_params(tree, heads), extras


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 values stored as their uint16 bits → the same values in f32 (exact)."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32) << 16).view(np.float32)


def convert_params(params: dict, heads: tuple[str, ...] | None = None) -> dict[str, torch.Tensor]:
    """Nested numpy parameter dict → ``Diffusion2D`` or ``Diffusion3D``
    state_dict (float32).

    Each top-level key becomes the state_dict prefix (``encoder.``,
    ``rel_head.``, ``denoiser.``), so a single module's subtree converts on
    its own too. ``heads`` names the denoiser's Dense→GELU→Dense heads in
    creation order (``HEADS_3D`` for the 3D model); None takes the 2D
    denoiser's."""
    if "denoiser" in params:
        params = {**params, "denoiser": _denoiser_heads(params["denoiser"], heads)}
    out = {}
    for path, arr in _flatten(params):
        name, value = _leaf(path[-1], np.asarray(arr, dtype=np.float32), path[-2] if len(path) > 1 else None)
        key = ".".join([_rename(seg, path[i - 1] if i else None) for i, seg in enumerate(path[:-1])] + [name])
        out[key] = torch.from_numpy(np.array(value, order="C"))
    return out
