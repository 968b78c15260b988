"""Dataset preprocessing — port of the JAX package's ``cli/preprocess.py``
(the reference's ``create_memmap_dt.py``): an image folder written once into
one memory-mapped uint8 ``.npy`` (N, size, size, 3) with a ``.json`` index,
so that training never decodes a JPEG. The images must already be
size × size; reading them needs PIL.

    python -m diffassemble_tpu_torch.cli.preprocess --src datasets/celeba-hq \
        --out datasets/celeba_192.npy --size 192
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_memmap(src: str, out: str, size: int, limit: int | None = None) -> int:
    """The first ``limit`` images of ``src`` (all by default) into ``out``; returns their number."""
    from ..data.datasets import ImageFolder

    folder = ImageFolder(src, None, (size, size))
    n = len(folder) if limit is None else min(limit, len(folder))
    arr = np.lib.format.open_memmap(out, mode="w+", dtype=np.uint8, shape=(n, size, size, 3))
    for i in range(n):
        arr[i] = (folder[i] * 255).astype(np.uint8)
    arr.flush()
    Path(out).with_suffix(".json").write_text(
        json.dumps({"n": n, "size": size, "files": [str(f) for f in folder.files[:n]]})
    )
    return n


class MemmapImages:
    """An image source over a ``build_memmap`` shard, (H, W, 3) float32 in
    [0, 1] per index (a ``PuzzleDataset``'s ``images``)."""

    def __init__(self, path: str):
        self.arr = np.load(path, mmap_mode="r")

    def __len__(self) -> int:
        return len(self.arr)

    def __getitem__(self, idx: int) -> np.ndarray:
        return np.asarray(self.arr[idx], dtype=np.float32) / 255.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", type=str, required=True)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args()
    n = build_memmap(args.src, args.out, args.size, args.limit)
    print(f"wrote {n} images to {args.out}")


if __name__ == "__main__":
    main()
