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
