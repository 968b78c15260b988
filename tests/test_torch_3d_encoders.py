"""The port's other point encoders against the JAX package's, on the CPU:
``PointNet`` (with and without its T-nets), ``PointNetPlus`` and
``VNPointNetEncoder`` (``nn/pointnet.py``, ``nn/vn.py``), with seeded
weights and with the pose-pretrained ``weights/pointnet_pose3d.npz``, and the
VN-DGCNN of ``weights/vn_dgcnn_rich_rel3d.npz`` on its pretraining corpus.

Inputs and parameters come from numpy seeds; the JAX side runs on the CPU in
f32. Tolerances are set from the spread that one unit in the last place of
input noise gives the port's own output (``tests/torch_assets.py:
encoder_conditioning``, the method of ``vn_dgcnn_conditioning``; 10 draws
on a CPU):

- the PointNet encoders: sums of up to 1024 products in another order, no
  normalisation that amplifies them; seeded at 1e-5 of the output's largest
  entry (measured at most 2.2e-6, T-nets included), the pose-pretrained
  encoder at 1e-5 (measured 4.0e-7; its one-ulp spread 5.6e-7);
- VN-PointNet, seeded: 1e-4 (measured 5.0e-6; one-ulp spread at most
  5.4e-6);
- the trained VN-DGCNN (``vn_dgcnn_rich``): its VNNorms amplify rounding, so
  one ulp of input noise moves its output by a median 1.0e-2 and at most
  2.2e-2 of the largest entry. The port is held to 3e-2 at its worst entry
  (measured 3.7e-4) and to 1e-5 at its median entry (measured 2.5e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.data.breaking_bad import SyntheticFractures, collate_fragments
from diffassemble_tpu.nn import pointnet as jpn
from diffassemble_tpu.nn.vn import VN_DGCNN as JVN
from diffassemble_tpu.nn.vn import VNPointNetEncoder as JVNP
from diffassemble_tpu.utils.params import load_params as jload
from diffassemble_tpu_torch.nn import pointnet as tpn
from diffassemble_tpu_torch.nn.layers import init_weights
from diffassemble_tpu_torch.nn.vn import VN_DGCNN, VNPointNetEncoder
from test_torch_3d import _init_shapes, _load, seeded_tree

SMALL = {
    "pointnet": (lambda: jpn.PointNet(feat_dim=16), lambda: tpn.PointNet(feat_dim=16), 1e-5),
    "pointnet_inv": (lambda: jpn.PointNet(feat_dim=16, use_tnet=True), lambda: tpn.PointNet(feat_dim=16, use_tnet=True),
                     1e-5),
    "pointnet_plus": (lambda: jpn.PointNetPlus(feat_dim=16, n_centroids=16, k=8),
                      lambda: tpn.PointNetPlus(feat_dim=16, n_centroids=16, k=8), 1e-5),
    "vnn": (lambda: JVNP(output_dim=24, n_knn=8), lambda: VNPointNetEncoder(output_dim=24, n_knn=8), 1e-4),
}


def _points(seed=3, shape=(3, 64, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _relative_err(got: torch.Tensor, want) -> np.ndarray:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return np.abs(got - want) / max(np.abs(want).max(), 1e-6)


def _clouds(n_objects, num_points, seed, **kw):
    """The valid part clouds (n, num_points, 3) of a few synthetic objects."""
    ds = SyntheticFractures(n_objects, num_points, 2, 4, seed=seed, **kw)
    nb = collate_fragments([ds[i] for i in range(n_objects)], 4, rng=np.random.default_rng(0))
    return nb.pcds[nb.node_mask]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_point_encoder_matches_with_seeded_weights(name):
    make_j, make_t, tol = SMALL[name]
    pts = _points()
    jm = make_j()
    params = seeded_tree(_init_shapes(jm, jnp.asarray(pts)), 1)
    want = jm.apply({"params": params}, jnp.asarray(pts))
    tm = make_t()
    _load(tm, params, "encoder")
    with torch.no_grad():
        got = tm(torch.tensor(pts))
    assert _relative_err(got, want).max() <= tol


@pytest.mark.parametrize("name", ["pointnet", "pointnet_plus"])
def test_point_encoder_input_gradients_match(name):
    """The max-pool's gradient goes to one winner per channel in both
    packages (the first maximum), through the gathers of the set abstraction
    too."""
    make_j, make_t, _ = SMALL[name]
    pts = _points(4)
    jm = make_j()
    params = seeded_tree(_init_shapes(jm, jnp.asarray(pts)), 2)
    cot = np.random.default_rng(5).standard_normal((3, 16)).astype(np.float32)
    want = jax.jit(jax.grad(lambda x: jnp.sum(jm.apply({"params": params}, x) * cot)))(jnp.asarray(pts))
    tm = make_t()
    _load(tm, params, "encoder")
    x = torch.tensor(pts, requires_grad=True)
    (tm(x) * torch.tensor(cot)).sum().backward()
    assert _relative_err(x.grad, want).max() <= 1e-5


def test_pose_pretrained_pointnet_features_match():
    """``weights/pointnet_pose3d.npz``'s encoder on its pretraining corpus
    (1000 points, canonical 0.85)."""
    tree = jload("weights/pointnet_pose3d.npz")
    pts = _clouds(2, 1000, 6, canonical=0.85)
    want = jpn.PointNet(feat_dim=128).apply({"params": tree["encoder"]}, jnp.asarray(pts))
    tm, dim = tpn.make_point_encoder("pointnet")
    _load(tm, tree["encoder"], "encoder")
    with torch.no_grad():
        got = tm(torch.tensor(pts))
    assert got.shape == (len(pts), dim)
    assert _relative_err(got, want).max() <= 1e-5


def test_rel_pretrained_vn_dgcnn_rich_features_match():
    """``weights/vn_dgcnn_rich_rel3d.npz``'s encoder on its pretraining
    corpus (256 points, canonical 0.6, wall detail 0.06, boost 2): the
    median entry to rounding, the worst within the one-ulp spread."""
    tree = jload("weights/vn_dgcnn_rich_rel3d.npz")
    pts = _clouds(2, 256, 5, canonical=0.6, wall_detail=0.06, wall_boost=2)
    want = JVN(feat_dim=128, both=True, pool="mean_maxnorm").apply({"params": tree["encoder"]}, jnp.asarray(pts))
    tm, dim = tpn.make_point_encoder("vn_dgcnn_rich")
    _load(tm, tree["encoder"], "encoder")
    with torch.no_grad():
        got = tm(torch.tensor(pts))
    assert got.shape == (len(pts), dim)
    err = _relative_err(got, want)
    assert np.median(err) <= 1e-5 and err.max() <= 3e-2


def test_vn_point_encoder_is_rotation_equivariant_before_its_projection():
    """VN-PointNet's pooled vector feature turns with the input: the
    projection's input for R·x is the rotated feature, to rounding."""
    pts = _points(7, (2, 48, 3))
    tm = VNPointNetEncoder(output_dim=24, n_knn=8)
    init_weights(tm, torch.Generator().manual_seed(0))
    seen = []
    tm.fc1.register_forward_hook(lambda m, a, o: seen.append(a[0].reshape(a[0].shape[0], -1, 3)))
    q, _ = np.linalg.qr(np.random.default_rng(8).standard_normal((3, 3)))
    rot = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    with torch.no_grad():
        tm(torch.tensor(pts))
        tm(torch.tensor(pts @ rot.T))
    a, b = seen
    assert torch.allclose(a @ torch.tensor(rot.T), b, atol=1e-4 * float(a.abs().max()))
