"""Parameter (sub)trees as flattened npz — port of the JAX package's ``utils/params.py``.

The npz keys are ``a/b/c`` paths into the JAX package's nested parameter
tree (the format of its pretrained encoders, ``encoder_init``). These helpers
read and write that format with numpy alone; ``convert.convert_params``
turns a loaded tree into this package's state dict.
"""

from __future__ import annotations

import numpy as np


def save_params(path, tree: dict) -> None:
    """Nested dict of arrays → npz with ``a/b/c`` keys."""

    def flat(t, prefix=()):
        for key, val in t.items():
            if isinstance(val, dict):
                yield from flat(val, prefix + (key,))
            else:
                yield "/".join(prefix + (key,)), np.asarray(val)

    np.savez(path, **dict(flat(tree)))


def load_params(path) -> dict:
    """npz with ``a/b/c`` keys → nested dict of numpy arrays."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return out


def tree_shapes_match(a: dict, b: dict) -> bool:
    """Same nested keys and the same leaf shapes."""
    if isinstance(a, dict) != isinstance(b, dict):
        return False
    if not isinstance(a, dict):
        return np.shape(a) == np.shape(b)
    return a.keys() == b.keys() and all(tree_shapes_match(a[k], b[k]) for k in a)
