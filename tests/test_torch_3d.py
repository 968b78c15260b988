"""The port's 3D geometry and modules against the JAX package's, on the CPU:
kNN (with ties) and Chamfer (``ops/knn.py``), the VN-DGCNN encoder
(``nn/vn.py``), the relative-pose head and its consensus (``nn/relpose.py``),
``GraphDenoiser3D`` and the 3D metrics (``models/losses_3d.py``).

Inputs and parameters come from numpy seeds; the JAX side runs on the CPU.
Tolerances (f32): kNN indices exactly, in bf16 too; Chamfer terms 1e-6
relative to their largest; modules 1e-4 of the output's largest entry (sums
of up to a few hundred products in another order, through normalisations),
except VN-DGCNN at 1e-3: its VNNorm standardizes vector norms whose spread
over the N·k edges is small next to their mean, which with seeded weights
amplifies f32 rounding about a hundredfold in a layer (measured: 3e-7 of the
largest entry after layer 0, 2.6e-5 after layer 1, 5e-4 at the output);
the relative-pose head and the metrics 1e-5. In bf16 a VN channel mix is
held to the JAX package's within one bf16 unit in the last place on at most
1e-3 of its entries, plus the f32 error of its sum where the sum cancels
(both sum exact bf16 products in f32, in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.models import losses_3d as jl3
from diffassemble_tpu.nn import relpose as jrel
from diffassemble_tpu.nn.denoiser import GraphDenoiser3D as JDenoiser3D
from diffassemble_tpu.nn.vn import VN_DGCNN as JVN
from diffassemble_tpu.nn.vn import VNLinear as JVNLinear
from diffassemble_tpu.ops import knn as jknn
from diffassemble_tpu_torch import convert
from diffassemble_tpu_torch.models import losses_3d as tl3
from diffassemble_tpu_torch.nn import relpose as trel
from diffassemble_tpu_torch.nn.denoiser import GraphDenoiser3D
from diffassemble_tpu_torch.nn.pointnet import make_point_encoder
from diffassemble_tpu_torch.nn.vn import VN_DGCNN, VNLinear
from diffassemble_tpu_torch.ops import knn as tknn


def seeded_tree(shapes, seed: int):
    """Numpy parameters of a shape tree: kernels and the raw U/V projections
    at 1/√fan_in, scales near 1, biases small but non-zero, tables N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("kernel", "U", "V"):
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _init_shapes(module, *inputs):
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]


def _load(module: torch.nn.Module, params: dict, name: str) -> None:
    """Load a JAX subtree ``params`` converted under ``name`` strictly into ``module``."""
    state = convert.convert_params({name: jax.tree.map(np.asarray, params)}, convert.HEADS_3D)
    prefix = convert._rename(name) + "."
    module.load_state_dict({k[len(prefix):]: v for k, v in state.items()}, strict=True)


def _assert_close(got: torch.Tensor, want, rel=1e-4):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6))


# ------------------------------------------------------------------ kNN


def _tied_points():
    """Integer grid points: many exactly equal distances."""
    rng = np.random.default_rng(0)
    return rng.integers(-2, 3, size=(3, 40, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_indices_break_ties_by_the_lower_index_as_lax_top_k(dtype):
    pts = _tied_points()
    want = np.asarray(jknn.knn_indices(jnp.asarray(pts, dtype=dtype), 12))
    d = np.asarray(jknn.pairwise_sqdist(jnp.asarray(pts), jnp.asarray(pts)))
    assert (np.diff(np.sort(d, -1), axis=-1) == 0).mean() > 0.5  # ties are the rule here
    got = tknn.knn_indices(torch.tensor(pts).to(getattr(torch, dtype)), 12)
    assert np.array_equal(got.numpy(), want)


def test_knn_on_bf16_features_equals_the_jax_package():
    """bf16 features as layers 2 and 3 of VN-DGCNN see them: the same
    rounded distances, so the same neighbour sets in the same order."""
    x = np.random.default_rng(1).standard_normal((4, 64, 63)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    d_want = np.asarray(jknn.pairwise_sqdist(xj, xj).astype(jnp.float32))
    d_got = tknn.pairwise_sqdist(xt, xt)
    assert d_got.dtype == torch.bfloat16 and np.array_equal(d_got.float().numpy(), d_want)
    assert np.array_equal(tknn.knn_indices(xt, 20).numpy(), np.asarray(jknn.knn_indices(xj, 20)))


def test_nearest_neighbor_and_chamfer_distance():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 3, 50, 3)).astype(np.float32)
    b = rng.standard_normal((2, 3, 70, 3)).astype(np.float32)
    da, db = tknn.chamfer_distance(torch.tensor(a), torch.tensor(b))
    wa, wb = jknn.chamfer_distance(jnp.asarray(a), jnp.asarray(b))
    _assert_close(da, wa, 1e-6)
    _assert_close(db, wb, 1e-6)
    dist, idx = tknn.nearest_neighbor(torch.tensor(a), torch.tensor(b))
    wd, wi = jknn.nearest_neighbor(jnp.asarray(a), jnp.asarray(b))
    _assert_close(dist, wd, 1e-6)
    assert np.array_equal(idx.numpy(), np.asarray(wi))


# ------------------------------------------------------------ VN-DGCNN


@pytest.mark.parametrize("kwargs", [dict(both=True, pool="mean_maxnorm"), dict(invariant=True), dict()])
def test_vn_dgcnn_matches(kwargs):
    """64 points, k = 8, a narrow encoder (feat_dim 16)."""
    pts = np.random.default_rng(3).standard_normal((3, 64, 3)).astype(np.float32)
    jm = JVN(feat_dim=16, n_knn=8, **kwargs)
    params = seeded_tree(_init_shapes(jm, jnp.asarray(pts)), 4)
    want = jm.apply({"params": params}, jnp.asarray(pts))
    tm = VN_DGCNN(feat_dim=16, n_knn=8, **kwargs)
    _load(tm, params, "encoder")
    with torch.no_grad():
        got = tm(torch.tensor(pts))
    assert got.shape[-1] == tm.output_dim == jm.output_dim
    _assert_close(got, want, 1e-3)


@pytest.mark.parametrize("lead,c,d", [((4, 64, 8), 42, 21), ((2, 64), 63, 2048), ((4,), 2048, 1024)])
def test_vn_linear_in_bf16_matches_the_jax_package(lead, c, d):
    """The encoder's channel mixes at its widths (edge layers, the rich
    layer 5, the invariant head): bf16 in, f32 sums, one rounding."""
    rng = np.random.default_rng(c)
    x = jnp.asarray(rng.standard_normal(lead + (c, 3)), jnp.bfloat16)
    w = (rng.standard_normal((c, d)) / np.sqrt(c)).astype(np.float32)
    want = np.asarray(JVNLinear(d, dtype=jnp.bfloat16).apply({"params": {"kernel": w}}, x).astype(jnp.float32))
    tm = VNLinear(c, d)
    tm.weight.data = torch.tensor(w.T.copy())
    with torch.no_grad():
        got = tm(torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    # one bf16 unit in the last place, plus the f32 error of a sum of c products
    xw = np.einsum("...cv,cd->...dv", np.abs(np.asarray(x.astype(jnp.float32))),
                   np.abs(np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))))
    assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + c * 2.0**-24 * xw)
    assert np.mean(got != want) <= 1e-3


def test_point_encoder_table():
    """Every name of the JAX package's table builds, with its output width
    (``tests/test_torch_3d_encoders.py`` holds the new encoders' features to
    the JAX package's)."""
    for name, dim in (("vn_dgcnn", 768), ("vn_dgcnn_inv", 256), ("vn_dgcnn_equiv_inv", 1024),
                      ("vn_dgcnn_rich", 2048)):
        enc, out = make_point_encoder(name)
        assert out == dim == enc.output_dim
    pts = torch.tensor(np.random.default_rng(0).standard_normal((2, 40, 3)).astype(np.float32))
    for name, dim in (("pointnet", 128), ("pointnet_inv", 1024), ("pointnet_plus", 256), ("vnn", 2104)):
        enc, out = make_point_encoder(name)
        with torch.no_grad():
            assert out == dim and enc(pts).shape == (2, dim)
    with pytest.raises(ValueError):
        make_point_encoder("resnet")


# ---------------------------------------------------- relative-pose head


def _rel_inputs(seed, b=2, p=5, c=24, ci=16):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, p, c, 3)).astype(np.float32)
    inv = rng.standard_normal((b, p, ci)).astype(np.float32)
    return g, inv


def test_relpose_head_and_consensus():
    g, inv = _rel_inputs(5)
    jm = jrel.RelPoseHead(k=8, hidden=16)
    params = seeded_tree(_init_shapes(jm, jnp.asarray(g), jnp.asarray(inv)), 6)
    want = jm.apply({"params": params}, jnp.asarray(g), jnp.asarray(inv))
    tm = trel.RelPoseHead(24, 16, k=8, hidden=16)
    _load(tm, params, "relpose")
    with torch.no_grad():
        got = tm(torch.tensor(g), torch.tensor(inv))
    for x, y in zip(got, want):
        _assert_close(x, y, 1e-5)

    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 5, 4)).astype(np.float32)
    t = rng.standard_normal((2, 5, 3)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 0, 0, 0]], dtype=bool)
    want_c = jrel.rel_consensus(*want, jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask))
    got_c = trel.rel_consensus(*got, torch.tensor(q), torch.tensor(t), torch.tensor(mask))
    _assert_close(got_c, want_c, 1e-5)
    g2, inv2 = trel.split_equiv_inv(torch.zeros(2, 5, 48 + 7), 48)
    assert g2.shape == (2, 5, 16, 3) and inv2.shape == (2, 5, 7)


# ------------------------------------------------------------ denoiser


@pytest.mark.parametrize("rel_channels", [0, 13])
def test_graph_denoiser_3d_matches(rel_channels):
    b, p, f = 2, 5, 24
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, p, 7)).astype(np.float32)
    t = rng.integers(0, 20, (b, p)).astype(np.int32)
    feats = rng.standard_normal((b, p, f)).astype(np.float32)
    mask = np.ones((b, p), bool)
    mask[1, 3:] = False
    adj = mask[:, :, None] & mask[:, None, :]
    rel = rng.standard_normal((b, p, 13)).astype(np.float32) if rel_channels else None
    kw = dict(steps=20, feature_dim=f, n_layers=2, hidden_dim=16, heads=2, rel_channels=rel_channels)
    jm = JDenoiser3D(**kw)
    jin = [jnp.asarray(a) for a in (x, t, feats, adj, mask)]
    jrel_ctx = None if rel is None else jnp.asarray(rel)
    params = seeded_tree(_init_shapes(jm, *jin, jrel_ctx), 9)
    want = jm.apply({"params": params}, *jin, rel_ctx=jrel_ctx)
    tm = GraphDenoiser3D(**kw)
    _load(tm, params, "denoiser")
    with torch.no_grad():
        got = tm(*[torch.tensor(a) for a in (x, t, feats, adj, mask)],
                 rel_ctx=None if rel is None else torch.tensor(rel))
    assert got.dtype == torch.float32 and got.shape == (b, p, 7)
    _assert_close(got, want)


def test_graph_denoiser_3d_refuses_split_message_passing():
    """Split message passing runs on the transformer backbone only, as in the
    JAX package (``tests/test_torch_3d_dualstream.py`` holds it to the JAX
    package's); another backbone is refused."""
    GraphDenoiser3D(steps=10, equiv_inv_mp=True)
    with pytest.raises(ValueError, match="transformer"):
        GraphDenoiser3D(steps=10, equiv_inv_mp=True, architecture="exophormer")


# -------------------------------------------------------------- metrics


def test_metrics_3d_match():
    rng = np.random.default_rng(10)
    b, p, n = 3, 4, 30
    pts = rng.standard_normal((b, p, n, 3)).astype(np.float32) * 0.2
    q1, q2 = (rng.standard_normal((b, p, 4)).astype(np.float32) for _ in range(2))
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    q2 = q1 + 0.05 * q2
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    t1 = rng.standard_normal((b, p, 3)).astype(np.float32) * 0.1
    t2 = t1 + 0.02 * rng.standard_normal((b, p, 3)).astype(np.float32)
    v = np.ones((b, p), bool)
    v[2, 2:] = False
    J = [jnp.asarray(a) for a in (pts, t1, t2, q1, q2, v)]
    T = [torch.tensor(a) for a in (pts, t1, t2, q1, q2, v)]
    _assert_close(tl3.transform_pc(T[1], T[3], T[0]), jl3.transform_pc(J[1], J[3], J[0]), 1e-6)
    _assert_close(tl3.trans_rmse(T[1], T[2], T[5]), jl3.trans_rmse(J[1], J[2], J[5]), 1e-5)
    _assert_close(tl3.rot_euler_rmse(T[3], T[4], T[5]), jl3.rot_euler_rmse(J[3], J[4], J[5]), 1e-5)
    _assert_close(tl3.rot_geodesic(T[3], T[4], T[5]), jl3.rot_geodesic(J[3], J[4], J[5]), 1e-5)
    got = tl3.part_accuracy(*T)
    assert np.array_equal(got.numpy(), np.asarray(jl3.part_accuracy(*J)))
    assert 0 < float(got.mean()) < 1  # some parts on each side of the gate
