"""2D image sources and puzzle datasets — port of the JAX package's
``data/datasets.py`` (host-side numpy; the same bytes as the JAX package's).

- ``SyntheticImages``: the procedural image source (no disk needed), so that
  training, tests and the smoke run hermetically;
- ``PuzzleDataset``: random puzzle size per sample from a list, patchify,
  grid targets, rotation, missing pieces, fully connected / expander /
  unique-graph / random-dropout topology;
- ``get_dataset``: (train, test, puzzle_sizes).

- ``ImageFolder``: images on disk (CelebA-HQ, WikiArt, ...), decoded by PIL,
  which is imported only when a folder is made;
- ``_resize``: PIL's resize, or nearest-neighbour indexing where PIL is
  missing (as on the card), as the JAX package falls back.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .expander import cached_expander_mask, expander_mask
from .patchify import make_puzzle


class SyntheticImages:
    """Procedural RGB images: smooth low-frequency fields + random rectangles.

    Deterministic per (seed, index) so train/test splits are reproducible.
    """

    def __init__(
        self,
        size_hw: tuple[int, int],
        n: int = 1000,
        seed: int = 0,
        cache: bool = True,
        canonical: float = 0.5,
        hf_detail: float = 0.0,
        style: str = "default",
    ):
        self.size_hw = size_hw
        self.n = n
        self.seed = seed
        self.canonical = canonical  # weight of the fixed aligned component
        # style="art": the WikiArt-hardness regime (VERDICT r3 next #9). The
        # reference's WikiArt table is where its method degrades (90.65% →
        # 53.08%, page/results2d.png) because paintings are UNALIGNED with
        # huge cross-image texture variance and large ambiguous flat regions.
        # The procedural analog: no shared canonical field beyond `canonical`
        # (recommend ≤0.1), per-image random palettes, multi-octave brushwork
        # at RANDOM orientations (killing per-patch orientability), and a
        # low-frequency "sky" mask blending in flat color regions.
        self.style = style
        # weight of FIXED high-frequency canonical texture. The base canonical
        # field tops out at 4.8 cycles/image: at 30×30 (patch = 1/30 of the
        # image) adjacent patches differ by <0.2 cycles of phase, so per-patch
        # absolute position saturates at coarse precision (measured round 3:
        # pose-readout 12% cell accuracy at 900 cells, diffusion plateau ~55%).
        # Aligned CelebA faces carry position-specific detail at every scale;
        # hf_detail adds the procedural analog — incommensurate 8-31
        # cycles/image sinusoid products whose joint phase is unique per cell.
        self.hf_detail = hf_detail
        # procedural generation costs ~30ms/image on a weak host — cache the
        # uint8 images (≤ ~110 MB for 1000 192² images) so only epoch 1 pays
        self._cache: dict[int, np.ndarray] | None = {} if cache else None

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx].astype(np.float32) / 255.0
        img = self._generate_art(idx) if self.style == "art" else self._generate(idx)
        if self._cache is not None:
            self._cache[idx] = (img * 255).astype(np.uint8)
        return img

    def _generate_art(self, idx: int) -> np.ndarray:
        """WikiArt-hardness procedural paintings (style='art'): random
        palette, randomly-oriented multi-octave brushwork, flat regions."""
        h, w = self.size_hw
        rng = np.random.default_rng((self.seed, idx, 7))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy, xx = yy / h, xx / w
        tp = 2 * np.pi
        # per-image palette: 2-4 anchor colors
        n_col = int(rng.integers(2, 5))
        palette = rng.uniform(0, 1, (n_col, 3)).astype(np.float32)
        # mixing field: 3-6 octaves of sinusoid products at random orientation
        field = np.zeros((h, w), dtype=np.float32)
        for _ in range(int(rng.integers(3, 7))):
            th = rng.uniform(0, np.pi)
            u = np.cos(th) * xx + np.sin(th) * yy
            v = -np.sin(th) * xx + np.cos(th) * yy
            f = rng.uniform(1.5, 40.0)
            field += rng.uniform(0.3, 1.0) * np.sin(tp * f * u + rng.uniform(0, tp)) * np.cos(
                tp * f * rng.uniform(0.3, 1.5) * v + rng.uniform(0, tp)
            )
        field = (field - field.min()) / max(float(np.ptp(field)), 1e-6)
        # palette lookup with smooth interpolation
        pos = field * (n_col - 1)
        lo = np.clip(pos.astype(np.int32), 0, n_col - 2)
        frac = (pos - lo)[..., None]
        img = palette[lo] * (1 - frac) + palette[lo + 1] * frac
        # large flat "sky" region: low-frequency mask toward one flat color
        thm = rng.uniform(0, np.pi)
        um = np.cos(thm) * xx + np.sin(thm) * yy
        mask = 0.5 + 0.5 * np.tanh(6.0 * (um - rng.uniform(0.3, 0.7)))
        sky = rng.uniform(0, 1, 3).astype(np.float32)
        img = img * (1 - mask[..., None] * 0.85) + sky * (mask[..., None] * 0.85)
        # a small aligned component if requested (canonical ~0.1 keeps the
        # task solvable-in-principle the way real paintings keep horizon cues)
        if self.canonical > 0:
            canon = np.stack(
                [0.5 + 0.3 * (xx - 0.5), 0.5 - 0.3 * (yy - 0.5),
                 0.5 + 0.6 * (xx - 0.5) * (yy - 0.5)], axis=-1)
            img = (1 - self.canonical) * img + self.canonical * canon
        # occasional figures
        for _ in range(int(rng.integers(0, 6))):
            y0, x0 = rng.integers(0, h * 3 // 4), rng.integers(0, w * 3 // 4)
            dy, dx = rng.integers(h // 12, h // 3), rng.integers(w // 12, w // 3)
            col = rng.uniform(0, 1, 3).astype(np.float32)
            cy, cx = y0 + dy / 2, x0 + dx / 2
            m = ((yy * h - cy) / max(dy / 2, 1)) ** 2 + ((xx * w - cx) / max(dx / 2, 1)) ** 2 < 1
            img[m] = 0.55 * img[m] + 0.45 * col
        return np.clip(img, 0.0, 1.0).astype(np.float32)

    def _generate(self, idx: int) -> np.ndarray:
        """Canonically-aligned procedural images: a FIXED low-frequency field
        shared by every image (weight `canonical`) + per-image random
        sub-cycle gradients + random rectangles/ellipses for texture.

        The fixed component matters: the reference's benchmark images
        (CelebA-HQ) are ALIGNED faces, so a patch's absolute position (and
        rotation) is decodable from its content alone — the signal both the
        per-patch visual features and the rotation recipe rely on. A purely
        phase-randomized generator destroys that signal (measured: ridge
        probe of patch→position R²≈0.01 from mean color, and per-patch
        readouts pin at the mean floor), leaving position inferable only
        from cross-patch context — a strictly HARDER task than the real
        benchmark. The canonical field restores aligned-data statistics
        while staying procedural; it is x/y-asymmetric so patch rotation is
        detectable per-patch too."""
        h, w = self.size_hw
        rng = np.random.default_rng((self.seed, idx))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy, xx = yy / h, xx / w
        img = np.zeros((h, w, 3), dtype=np.float32)
        cw = self.canonical
        # fixed canonical field (same for every image, like face alignment):
        # per-channel asymmetric ramps/curves in x vs y
        # low-frequency ramps give coarse position; fixed MID-frequency
        # patterns (the procedural analog of facial features) give every
        # 32 px patch a distinctive local phase signature a conv net can
        # place — and, being x/y-asymmetric, orient.
        canon = np.stack(
            [
                0.5
                + 0.30 * (xx - 0.5)
                + 0.18 * np.sin(2.5 * yy)
                + 0.20 * np.sin(2 * np.pi * 3.3 * xx + 0.7) * np.cos(2 * np.pi * 1.9 * yy),
                0.5
                - 0.26 * (yy - 0.5)
                + 0.20 * np.sin(1.7 * xx + 0.4)
                + 0.20 * np.sin(2 * np.pi * 2.6 * yy + 0.3) * np.cos(2 * np.pi * 4.1 * xx + 1.1),
                0.5
                + 0.22 * (xx - 0.5) * (yy - 0.5) * 4.0
                + 0.14 * np.cos(2.2 * xx)
                + 0.20 * np.sin(2 * np.pi * 4.8 * xx + 2.0) * np.sin(2 * np.pi * 3.1 * yy + 0.9),
            ],
            axis=-1,
        )
        if self.hf_detail > 0:
            tp = 2 * np.pi
            hf = np.stack(
                [
                    np.sin(tp * 11.3 * xx + 0.5) * np.cos(tp * 7.7 * yy + 1.3)
                    + 0.6 * np.sin(tp * 23.7 * xx + 2.9) * np.sin(tp * 17.3 * yy + 0.8),
                    np.sin(tp * 13.9 * xx + 2.1) * np.cos(tp * 9.4 * yy + 0.2)
                    + 0.6 * np.cos(tp * 19.1 * xx + 1.1) * np.sin(tp * 27.9 * yy + 2.2),
                    np.sin(tp * 8.6 * xx + 1.7) * np.cos(tp * 12.8 * yy + 2.6)
                    + 0.6 * np.sin(tp * 30.7 * xx + 0.3) * np.cos(tp * 21.6 * yy + 1.9),
                ],
                axis=-1,
            )
            canon = canon + self.hf_detail * hf
        for c in range(3):
            fx, fy = rng.uniform(0.25, 0.9, 2)  # < 1 cycle ⇒ no positional aliasing
            px, py = rng.uniform(0, 2 * np.pi, 2)
            img[..., c] = 0.5 + 0.22 * np.sin(2 * np.pi * fx * xx + px) + 0.22 * np.cos(
                2 * np.pi * fy * yy + py
            )
        img = cw * canon + (1.0 - cw) * img
        for _ in range(8):
            y0, x0 = rng.integers(0, h * 3 // 4), rng.integers(0, w * 3 // 4)
            dy, dx = rng.integers(h // 10, h // 3), rng.integers(w // 10, w // 3)
            col = rng.uniform(0, 1, 3).astype(np.float32)
            if rng.random() < 0.5:
                img[y0 : y0 + dy, x0 : x0 + dx] = (
                    0.5 * img[y0 : y0 + dy, x0 : x0 + dx] + 0.5 * col
                )
            else:  # ellipse
                cy, cx = y0 + dy / 2, x0 + dx / 2
                m = ((yy * h - cy) / max(dy / 2, 1)) ** 2 + ((xx * w - cx) / max(dx / 2, 1)) ** 2 < 1
                img[m] = 0.5 * img[m] + 0.5 * col
        return np.clip(img, 0.0, 1.0)


class ImageFolder:
    """Images from a directory or a file-list split (CelebA-HQ / WikiArt style:
    reference celeba_dt.py / wikiart_dt.py read data_splits/*.txt), decoded by
    PIL as (H, W, 3) float32 in [0, 1]; PIL is imported when a folder is made."""

    def __init__(self, root: str, split_file: str | None = None, size_hw: tuple[int, int] = (192, 192)):
        from PIL import Image  # noqa: F401 — fail here, not at the first image

        self.root = Path(root)
        if split_file:
            names = [ln.strip() for ln in open(split_file) if ln.strip()]
            self.files = [self.root / n for n in names]
        else:
            exts = {".jpg", ".jpeg", ".png", ".webp", ".bmp"}
            self.files = sorted(p for p in self.root.rglob("*") if p.suffix.lower() in exts)
        self.size_hw = size_hw

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.files[idx]).convert("RGB")
        return np.asarray(img, dtype=np.float32) / 255.0


class PuzzleDataset:
    """Random-size jigsaw puzzles from an image source (reference
    Puzzle_Dataset / _ROT / _MP, puzzle_dataset.py:215-716).

    Yields make_puzzle() dicts + 'adj' (N, N) topology + 'patches_dim'.
    """

    def __init__(
        self,
        images,
        puzzle_sizes: list[tuple[int, int]],
        patch_size: int = 32,
        rotation: bool = False,
        degree: int | str = -1,
        unique_graph: bool = False,
        missing_perc: int = 0,
        inference_full: bool = False,
        padding: int = 0,
        random_dropout: float = 0.0,
        seed: int = 0,
    ):
        self.images = images
        self.puzzle_sizes = [tuple(s) for s in puzzle_sizes]
        self.patch_size = patch_size
        self.rotation = rotation
        self.degree = degree
        self.unique_graph = unique_graph
        self.missing_perc = missing_perc
        self.inference_full = inference_full
        self.padding = padding
        self.random_dropout = random_dropout
        self.seed = seed

    def __len__(self) -> int:
        return len(self.images)

    @property
    def max_nodes(self) -> int:
        return max(h * w for h, w in self.puzzle_sizes)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng((self.seed, idx))
        ph, pw = self.puzzle_sizes[rng.integers(len(self.puzzle_sizes))]
        img = self.images[idx]
        want = (ph * self.patch_size, pw * self.patch_size)
        if img.shape[:2] != want:
            img = _resize(img, want)
        sample = make_puzzle(img, ph, pw, self.patch_size, rotation=self.rotation, rng=rng)
        if self.padding > 0:
            # eroded pieces: zero an n-pixel border of every patch — the
            # Puzzle_Dataset_Pad mode (reference puzzle_dataset.py:303-380,
            # without its `self.trans/forms` typo at :346-348)
            pz = self.padding
            sample["patches"][:, :pz, :, :] = 0
            sample["patches"][:, -pz:, :, :] = 0
            sample["patches"][:, :, :pz, :] = 0
            sample["patches"][:, :, -pz:, :] = 0
        n = ph * pw

        if self.missing_perc > 0:
            # drop ⌈N·perc/100⌉ random pieces (reference :382-485)
            n_drop = int(np.ceil(n * self.missing_perc / 100))
            keep = rng.permutation(n)[: n - n_drop]
            keep.sort()
            for key in ("patches", "x0", "grid", "rot_k"):
                sample[key] = sample[key][keep]
            n = len(keep)

        if self.random_dropout > 0 and not self.inference_full:
            # random edge subsampling instead of an expander
            # (reference puzzle_dataset.py:615-628)
            from .expander import random_dropout_mask

            adj = random_dropout_mask(n, 1.0 - self.random_dropout, rng)
        elif self.degree == -1 or self.inference_full:
            adj = np.ones((n, n), dtype=bool)
        elif self.unique_graph:
            adj = cached_expander_mask(n, str(self.degree), self.seed)
        else:
            adj = expander_mask(n, self.degree, rng)
        sample["adj"] = adj
        sample["patches_dim"] = np.array([ph, pw], dtype=np.int32)
        sample["index"] = idx
        return sample


def _resize(img: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """(H, W, 3) in [0, 1] → ``size_hw``: PIL's default resample of the uint8
    image, or without PIL nearest-neighbour indexing."""
    try:
        from PIL import Image
    except ImportError:
        h, w = size_hw
        yi = (np.arange(h) * img.shape[0] / h).astype(int)
        xi = (np.arange(w) * img.shape[1] / w).astype(int)
        return img[yi][:, xi]
    pil = Image.fromarray((img * 255).astype(np.uint8)).resize((size_hw[1], size_hw[0]))
    return np.asarray(pil, dtype=np.float32) / 255.0


def get_dataset(
    dataset: str = "synthetic",
    puzzle_sizes: list[tuple[int, int]] | list[int] = (6,),
    patch_size: int = 32,
    rotation: bool = False,
    degree: int | str = -1,
    missing_perc: int = 0,
    padding: int = 0,
    random_dropout: float = 0.0,
    unique_graph: bool = False,
    inf_fully: bool = True,
    data_root: str | None = None,
    train_n: int = 2000,
    test_n: int = 200,
    seed: int = 0,
    canonical: float = 0.5,
    hf_detail: float = 0.0,
):
    """Dataset factory (reference dataset_utils.get_dataset/get_dataset_ROT/
    get_dataset_missing_pieces :29,107,165). Returns (train, test, sizes).

    `dataset`: synthetic | celeba | wikiart | <path to image folder>.
    Test split always uses the full graph unless inf_fully=False (:99).
    """
    sizes = [(s, s) if isinstance(s, int) else tuple(s) for s in puzzle_sizes]
    max_hw = max(max(h, w) for h, w in sizes)
    size_hw = (max_hw * patch_size, max_hw * patch_size)

    def image_source(split: str, n: int, seed_off: int):
        if dataset in ("synthetic", "synthetic_art"):
            return SyntheticImages(
                size_hw, n=n, seed=seed + seed_off,
                canonical=canonical, hf_detail=hf_detail,
                style="art" if dataset == "synthetic_art" else "default",
            )
        root = data_root or os.environ.get("DIFFASSEMBLE_DATA", "datasets")
        split_dir = Path(root) / "data_splits"
        split_map = {
            "celeba": (Path(root) / "celeba-hq", split_dir / f"CelebA-HQ_{split}.txt"),
            "wikiart": (Path(root) / "wikiart", split_dir / f"wikiart_subset_{split}.txt"),
        }
        if dataset in split_map:
            img_root, split_file = split_map[dataset]
            if split_file.exists():
                return ImageFolder(str(img_root), str(split_file), size_hw)
            return ImageFolder(str(img_root), None, size_hw)
        if dataset in ("cifar100", "imagenet"):
            # torchvision-style folder layouts under the data root
            return ImageFolder(str(Path(root) / dataset / split), None, size_hw)
        return ImageFolder(dataset, None, size_hw)

    mk = lambda imgs, split_seed, inf: PuzzleDataset(
        imgs, sizes, patch_size, rotation=rotation, degree=degree,
        unique_graph=unique_graph, missing_perc=missing_perc,
        inference_full=inf, padding=padding, random_dropout=random_dropout,
        seed=seed + split_seed,
    )
    train = mk(image_source("train", train_n, 0), 0, False)
    test = mk(image_source("test", test_n, 1), 1, inf_fully)
    return train, test, sizes
