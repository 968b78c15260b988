"""The port's data copies against the JAX package's: byte-identical for the same seed."""

import numpy as np
import pytest

from diffassemble_tpu import data as jdata
from diffassemble_tpu_torch import data as tdata
from torch_assets import fixed_eigsh


def _img(seed, h, w):
    return np.random.default_rng(seed).random((h * 32, w * 32, 3)).astype(np.float32)


def test_grid_positions_identical():
    for h, w in ((3, 3), (2, 5), (30, 30)):
        a, b = jdata.grid_positions(h, w), tdata.grid_positions(h, w)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("rotation", [False, True])
@pytest.mark.parametrize("hw", [(3, 3), (2, 4)])
def test_make_puzzle_identical(rotation, hw):
    img = _img(0, *hw)
    a = jdata.make_puzzle(img, *hw, 32, rotation=rotation, rng=np.random.default_rng(7))
    b = tdata.make_puzzle(img, *hw, 32, rotation=rotation, rng=np.random.default_rng(7))
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def test_patchify_and_rotation_identical():
    img = _img(1, 2, 3)
    p = tdata.patchify(img, 2, 3, 32)
    assert np.array_equal(p, jdata.patchify(img, 2, 3, 32))
    assert np.array_equal(jdata.unpatchify(p, 2, 3), img)
    for q, (h, w) in ((p, (2, 3)), (tdata.patchify(_img(3, 4, 1), 4, 1, 32), (4, 1))):
        a, b = jdata.unpatchify(q, h, w), tdata.unpatchify(q, h, w)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rot_k = np.random.default_rng(2).integers(0, 4, size=6)
    assert np.array_equal(tdata.rotate_patches(p, rot_k), jdata.rotate_patches(p, rot_k))
    assert np.array_equal(tdata.ROT_VECTORS, jdata.ROT_VECTORS)


@pytest.fixture
def deterministic_eigsh():
    """ARPACK starts from a random vector of its own, so the Fiedler values, and
    with them which candidate graph is kept, vary from call to call in both
    packages alike; a fixed start vector makes the comparison exact."""
    with fixed_eigsh():
        yield


@pytest.mark.parametrize("n, degree", [(9, "10%"), (36, "10%"), (100, "10%"), (64, 5), (50, -1)])
def test_expander_mask_identical(n, degree, deterministic_eigsh):
    a = jdata.expander_mask(n, degree, np.random.default_rng(3))
    b = tdata.expander_mask(n, degree, np.random.default_rng(3))
    assert a.dtype == b.dtype == bool and np.array_equal(a, b)
    assert tdata.parse_degree(degree, n) == jdata.parse_degree(degree, n)


def test_collate_identical_and_to_device():
    rng = np.random.default_rng(4)
    samples = []
    for n in (4, 6):
        s = tdata.make_puzzle(_img(5, 2, n // 2), 2, n // 2, 32, rotation=True, rng=rng)
        s["adj"] = tdata.expander_mask(n, -1, rng)
        samples.append(s)
    a = jdata.collate_puzzles(samples, 8)
    b = tdata.collate_puzzles(samples, 8)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    t = b.to("cpu")
    assert all(np.array_equal(x.numpy(), y) for x, y in zip(t, b))


# the 3D data: the port's copy of breaking_bad.py and FragmentBatch


@pytest.mark.parametrize("kwargs", [
    dict(canonical=0.9, wall_detail=0.08, wall_boost=3),  # the trained checkpoint's corpus
    dict(canonical=0.6, voronoi=False),
    dict(canonical=0.6, wall_surface=True, wall_freq=5.0),
])
def test_synthetic_fractures_identical(kwargs):
    from diffassemble_tpu.data import breaking_bad as jbb
    from diffassemble_tpu_torch.data import breaking_bad as tbb

    a = jbb.SyntheticFractures(3, 64, 2, 6, seed=5, **kwargs)
    b = tbb.SyntheticFractures(3, 64, 2, 6, seed=5, **kwargs)
    assert a.category_names == b.category_names and len(a) == len(b)
    for i in range(len(a)):
        sa, sb = a[i], b[i]
        assert sa.keys() == sb.keys()
        for key in sa:
            x, y = np.asarray(sa[key]), np.asarray(sb[key])
            assert x.dtype == y.dtype and np.array_equal(x, y), key


@pytest.mark.parametrize("missing", [0, 40])
def test_collate_fragments_identical_and_to_device(missing):
    from diffassemble_tpu.data import breaking_bad as jbb
    from diffassemble_tpu_torch.data import breaking_bad as tbb

    _, test_a, cats_a = jbb.get_dataset_3d("synthetic", num_points=32, max_num_part=8, train_n=2, test_n=4, seed=3)
    _, test_b, cats_b = tbb.get_dataset_3d("synthetic", num_points=32, max_num_part=8, train_n=2, test_n=4, seed=3)
    assert cats_a == cats_b
    samples = [test_b[i] for i in range(4)]
    a = jbb.collate_fragments(samples, 8, missing_perc=missing, rng=np.random.default_rng(1))
    b = tbb.collate_fragments(samples, 8, missing_perc=missing, rng=np.random.default_rng(1))
    assert type(b).__name__ == type(a).__name__ == "FragmentBatch" and a._fields == b._fields
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    t = b.to("cpu")
    assert isinstance(t, tdata.FragmentBatch) and all(np.array_equal(x.numpy(), y) for x, y in zip(t, b))


# the text datasets: the port's copy of text.py


@pytest.mark.parametrize("seed", [0, 3])
def test_text_datasets_identical(seed, tmp_path):
    from diffassemble_tpu.data import text as jtext
    from diffassemble_tpu_torch.data import text as ttext

    corpus = tmp_path / "corpus.txt"
    corpus.write_text("one two three.\nfour five.\nsix seven eight.\nnine ten.\n\nshort.\n\n"
                      "a b.\nc d.\ne f.\ng h.\ni j.\nk l.\nm n.\no p.\nq r.\n")
    for path in (None, str(corpus)):
        pairs = [(jtext.get_dataset_text(path, seed=seed), ttext.get_dataset_text(path, seed=seed)),
                 (jtext.get_dataset_vist(path, seed=seed), ttext.get_dataset_vist(path, seed=seed))]
        for (ja, jb), (ta, tb) in pairs:
            for j, t in ((ja, ta), (jb, tb)):
                assert len(j) == len(t) and j.max_nodes == t.max_nodes
                samples = [t[i] for i in range(min(len(t), 5))]
                for i, s in enumerate(samples):
                    want = j[i]
                    assert want.keys() == s.keys()
                    for key in want:
                        x, y = np.asarray(want[key]), np.asarray(s[key])
                        assert x.dtype == y.dtype and np.array_equal(x, y), key
                a, b = jtext.collate_sequences(samples, t.max_nodes), ttext.collate_sequences(samples, t.max_nodes)
                assert a._fields == b._fields and all(x.dtype == y.dtype and np.array_equal(x, y)
                                                      for x, y in zip(a, b))
    feats = ["the same words", "other words here", ""]
    assert np.array_equal(jtext.hashed_ngram_features(feats, 64), ttext.hashed_ngram_features(feats, 64))
    assert np.array_equal(jtext.order_positions(7), ttext.order_positions(7))
