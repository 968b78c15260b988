"""Sentence-reordering / visual-storytelling datasets (1-D position graphs).

Capability parity with the reference's text extension (puzzle_diff/dataset/
text_dataset.py:21-67, vist_dataset.py:21, nips_dt.py, sind_dt.py, roc_dt.py,
wiki_dt.py, sind_vist_dt.py and the factories get_dataset_text/vist,
dataset_utils.py:383-423): treat the sentences of a document (or the images of
a photo-story) as pieces whose 1-D order must be recovered — positions are
scalars on [-1, 1], the graph is fully connected, and conditioning features
come from a text encoder.

The reference ships no entry point consuming these (SURVEY.md §2.5 'unused
extension'); here the loaders produce the same padded PuzzleBatch-style
tensors the 2D models consume, with `features` taking the place of patch
pixels. A bag-of-hashed-ngrams featurizer keeps this hermetic (no downloaded
embedding tables); any (N, F) feature matrix can be substituted.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import NamedTuple

import numpy as np


class SequenceBatch(NamedTuple):
    """Padded batch of ordered-sequence samples."""

    features: np.ndarray   # (B, N, F) per-element features
    x0: np.ndarray         # (B, N, 1) target scalar positions in [-1, 1]
    grid: np.ndarray       # (B, N, 1) anchor positions
    adj: np.ndarray        # (B, N, N)
    node_mask: np.ndarray  # (B, N)
    index: np.ndarray      # (B,)


def hashed_ngram_features(sentences: list[str], dim: int = 256) -> np.ndarray:
    """Deterministic bag-of-hashed-ngrams sentence features (N, dim)."""
    out = np.zeros((len(sentences), dim), dtype=np.float32)
    for i, s in enumerate(sentences):
        toks = s.lower().split()
        grams = toks + [" ".join(toks[j : j + 2]) for j in range(len(toks) - 1)]
        for g in grams:
            hv = int(hashlib.md5(g.encode()).hexdigest()[:8], 16)
            out[i, hv % dim] += 1.0
        norm = np.linalg.norm(out[i])
        if norm > 0:
            out[i] /= norm
    return out


def order_positions(n: int) -> np.ndarray:
    """(N, 1) scalar order targets in [-1, 1] (1-D analog of the 2D grid)."""
    return np.linspace(-1.0, 1.0, n, dtype=np.float32)[:, None]


class SentenceOrderingDataset:
    """Documents → shuffled-sentence reordering samples.

    Accepts a text file of documents separated by blank lines (the NIPS-
    abstract / ROCStories / SIND / Wiki-plots shape), or generates procedural
    documents when no corpus is on disk.
    """

    def __init__(
        self,
        corpus_path: str | None = None,
        n_sentences: tuple[int, int] = (4, 8),
        n_docs: int = 256,
        feature_dim: int = 256,
        seed: int = 0,
    ):
        self.feature_dim = feature_dim
        self.n_sentences = n_sentences
        self.seed = seed
        self.docs: list[list[str]] = []
        if corpus_path and Path(corpus_path).exists():
            doc: list[str] = []
            for line in open(corpus_path):
                line = line.strip()
                if not line:
                    if len(doc) >= n_sentences[0]:
                        self.docs.append(doc[: n_sentences[1]])
                    doc = []
                else:
                    doc.append(line)
            if len(doc) >= n_sentences[0]:
                self.docs.append(doc[: n_sentences[1]])
        else:
            rng = np.random.default_rng(seed)
            vocab = [f"tok{i}" for i in range(400)]
            for d in range(n_docs):
                n = int(rng.integers(n_sentences[0], n_sentences[1] + 1))
                self.docs.append(
                    [
                        " ".join(rng.choice(vocab, size=6 + (s % 3)).tolist())
                        + f" marker{d}_{s}"
                        for s in range(n)
                    ]
                )

    def __len__(self) -> int:
        return len(self.docs)

    @property
    def max_nodes(self) -> int:
        return self.n_sentences[1]

    def __getitem__(self, idx: int) -> dict:
        sents = self.docs[idx]
        n = len(sents)
        feats = hashed_ngram_features(sents, self.feature_dim)
        return {
            "features": feats,
            "x0": order_positions(n),
            "grid": order_positions(n),
            "index": idx,
        }


def collate_sequences(samples: list[dict], n_max: int) -> SequenceBatch:
    b = len(samples)
    f = samples[0]["features"].shape[-1]
    feats = np.zeros((b, n_max, f), dtype=np.float32)
    x0 = np.zeros((b, n_max, 1), dtype=np.float32)
    grid = np.zeros((b, n_max, 1), dtype=np.float32)
    mask = np.zeros((b, n_max), dtype=bool)
    index = np.zeros((b,), dtype=np.int32)
    for i, s in enumerate(samples):
        n = len(s["features"])
        feats[i, :n] = s["features"]
        x0[i, :n] = s["x0"]
        grid[i, :n] = s["grid"]
        mask[i, :n] = True
        index[i] = s["index"]
    adj = mask[:, :, None] & mask[:, None, :]
    return SequenceBatch(feats, x0, grid, adj, mask, index)


def get_dataset_text(corpus_path: str | None = None, seed: int = 0):
    """Factory (reference dataset_utils.get_dataset_text :383-411)."""
    train = SentenceOrderingDataset(corpus_path, n_docs=512, seed=seed)
    test = SentenceOrderingDataset(corpus_path, n_docs=64, seed=seed + 1)
    return train, test


def get_dataset_vist(root: str | None = None, seed: int = 0):
    """Factory (reference dataset_utils.get_dataset_vist :412-423) — photo
    stories; without the VIST corpus on disk the procedural generator stands
    in with image-free feature vectors."""
    return get_dataset_text(root, seed=seed)
