"""The port's 3D training geometry against the JAX package's, on the CPU: the
IGSO3 table and sampler (``ops/igso3.py``), the Chamfer distance's gradient
(``ops/knn.py``, the JAX custom VJP) and every loss of
``models/losses_3d.py``.

Inputs come from numpy seeds, the IGSO3 draws from the JAX package's keys.
Tolerances (f32): the IGSO3 table bit for bit (the same float64 numpy code on
the same schedule); sampled rotations 2e-6 (a gather, a lerp and Rodrigues);
Chamfer terms and gradients 1e-6 relative to their largest entry (both
gather the same argmin neighbours, ties to the lower index); the losses 1e-5
relative (sums of a few hundred f32 terms in another order), the contact
matrix exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.models import losses_3d as jl3
from diffassemble_tpu.models.diffusion_3d import Diffusion3D as JDiffusion3D
from diffassemble_tpu.models.diffusion_3d import Diffusion3DConfig as JConfig
from diffassemble_tpu.ops import igso3 as jigso3
from diffassemble_tpu.ops import knn as jknn
from diffassemble_tpu.ops import so3 as jso3
from diffassemble_tpu_torch.models import Diffusion3D, Diffusion3DConfig
from diffassemble_tpu_torch.models import losses_3d as tl3
from diffassemble_tpu_torch.ops import igso3 as tigso3
from diffassemble_tpu_torch.ops import knn as tknn

CFG = dict(backbone="vn_dgcnn", n_layers=1, hidden_dim=16, heads=2, compute_dtype="float32")


def _close(got, want, rel):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got.astype(np.float64), want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _quats(rng, shape):
    q = rng.standard_normal((*shape, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _poses(seed=0, b=2, p=3, n=40):
    """Clouds, two poses each and a valid mask with a padding part."""
    rng = np.random.default_rng(seed)
    pts = (0.3 * rng.standard_normal((b, p, n, 3))).astype(np.float32)
    t1, t2 = ((0.2 * rng.standard_normal((b, p, 3))).astype(np.float32) for _ in range(2))
    q1, q2 = _quats(rng, (b, p)), _quats(rng, (b, p))
    valids = np.ones((b, p), dtype=bool)
    valids[1, -1] = False
    return pts, t1, t2, q1, q2, valids


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


# ------------------------------------------------------------------- IGSO3


def test_igso3_table_is_the_jax_packages():
    jm = JDiffusion3D(JConfig(**CFG))
    tm = Diffusion3D(Diffusion3DConfig(**CFG), device="cpu")
    want = np.asarray(jm.igso3_table)
    assert tm.igso3_table.shape == want.shape == (300, 256) and tm.igso3_table.dtype == torch.float32
    assert np.array_equal(tm.igso3_table.numpy(), want)
    # a buffer (it follows the model's ``.to()``) outside the state_dict
    assert "igso3_table" in dict(tm.named_buffers()) and "igso3_table" not in tm.state_dict()
    eps = np.array([0.05, 0.3, 1.0])
    locs = np.linspace(0, np.pi, 50)
    assert np.array_equal(tigso3.igso3_angle_pdf(locs, eps), jigso3.igso3_angle_pdf(locs, eps))


def test_igso3_sample_on_the_jax_draws():
    """u and the axes from the keys the JAX sampler splits, steps 0 and T - 1
    among them."""
    table = jigso3.build_igso3_inverse_cdf(np.linspace(0.01, 1.0, 300))
    t = np.array([[0, 299, 17], [150, 1, 298]], dtype=np.int32)
    rng = jax.random.PRNGKey(11)
    want = jigso3.igso3_sample(rng, jnp.asarray(table), jnp.asarray(t))
    k_angle, k_axis = jax.random.split(rng)
    u = np.asarray(jax.random.uniform(k_angle, t.shape))
    axes = np.asarray(jax.random.normal(k_axis, (*t.shape, 3)))
    got = tigso3.igso3_sample(torch.tensor(table), torch.tensor(t), u=torch.tensor(u), axes=torch.tensor(axes))
    _close(got, want, 2e-6)
    r = got.double()
    assert torch.allclose(r @ r.transpose(-1, -2), torch.eye(3, dtype=torch.float64).expand(r.shape), atol=1e-5)


def test_igso3_draws_come_from_the_generator():
    table = torch.tensor(jigso3.build_igso3_inverse_cdf(np.linspace(0.01, 1.0, 30)))
    t = torch.tensor([[3, 29], [0, 12]])
    a = tigso3.igso3_sample(table, t, torch.Generator().manual_seed(1))
    b = tigso3.igso3_sample(table, t, torch.Generator().manual_seed(1))
    c = tigso3.igso3_sample(table, t, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_q_sample_rot_matches():
    jm = JDiffusion3D(JConfig(**CFG))
    tm = Diffusion3D(Diffusion3DConfig(**CFG), device="cpu")
    rng = np.random.default_rng(2)
    rot = np.asarray(jso3.quaternion_to_matrix(jnp.asarray(_quats(rng, (2, 3)))))
    t = np.array([[5, 5, 5], [280, 280, 280]], dtype=np.int32)
    key = jax.random.PRNGKey(4)
    want = jm.q_sample_rot(jnp.asarray(rot), jnp.asarray(t), key)
    k_angle, k_axis = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k_angle, t.shape))
    axes = np.asarray(jax.random.normal(k_axis, (*t.shape, 3)))
    got = tm.q_sample_rot(torch.tensor(rot), torch.tensor(t), u=torch.tensor(u), axes=torch.tensor(axes))
    _close(got, want, 1e-5)


# ----------------------------------------------------------------- Chamfer


def _chamfer_pair(seed, n, m):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, n, 3)).astype(np.float32)
    b = rng.standard_normal((2, m, 3)).astype(np.float32)
    # ties, where both packages take the lower index: b's points 3 and 7 at
    # one place, nearest to a's point 0; a's points 5 and 20 at one place (in
    # other chunks of 16 rows), nearest to b's point 10
    b[0, 7] = b[0, 3]
    a[0, 0] = b[0, 3] + 1e-3
    a[0, 20] = a[0, 5]
    b[0, 10] = a[0, 5] + 1e-3
    return a, b


@pytest.mark.parametrize("chunk", [None, 16], ids=["direct", "chunked"])
def test_chamfer_forward_and_gradient_match_jax(chunk):
    """``chunk`` 16 over 50 rows: three full chunks and a ragged one, with the
    column minimum carried across them."""
    a, b = _chamfer_pair(0, 50, 40)
    wa, wb = (np.random.default_rng(1).random(s).astype(np.float32) for s in ((2, 50), (2, 40)))

    def jloss(x, y):
        da, db = jknn.chamfer_distance(x, y, chunk=chunk)
        return jnp.sum(da * wa) + jnp.sum(db * wb), (da, db)

    (_, (da_j, db_j)), (ga_j, gb_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    da, db = tknn.chamfer_distance(ta, tb, chunk=chunk)
    ((da * torch.tensor(wa)).sum() + (db * torch.tensor(wb)).sum()).backward()
    for got, want in ((da, da_j), (db, db_j), (ta.grad, ga_j), (tb.grad, gb_j)):
        _close(got, want, 1e-6)
    _, _, i_a, i_b = tknn._chamfer_with_idx(ta.detach(), tb.detach(), chunk or 0)
    assert int(i_a[0, 0]) == 3 and int(i_b[0, 10]) == 5


def test_chamfer_chunks_agree_with_the_whole_matrix():
    """Any chunking gives the whole matrix's minima and argmins, and above 2M
    pairs the default scans 2048-row chunks."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.standard_normal((1, 2100, 3)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((1, 1000, 3)).astype(np.float32))
    d = tknn.pairwise_sqdist(a, b)
    whole = (*d.min(-1), *d.min(-2))
    whole = (whole[0], whole[2], whole[1], whole[3])  # (d_a, d_b, i_a, i_b)
    for chunk in (0, 700, 2048, 2099):
        for x, y in zip(tknn._chamfer_with_idx(a, b, chunk), whole):
            assert torch.equal(x, y)


# ------------------------------------------------------------------ losses


def test_pose_losses_match():
    pts, t1, t2, q1, q2, valids = _poses()
    tp = _t(pts, t1, t2, q1, q2, valids)
    jp = [jnp.asarray(x) for x in (pts, t1, t2, q1, q2, valids)]
    for name, args in (("trans_l2_loss", (1, 2, 5)), ("rot_cosine_loss", (3, 4, 5)), ("rot_l2_loss", (3, 4, 5)),
                       ("rot_points_l2_loss", (0, 3, 4, 5)), ("rot_points_cd_loss", (0, 3, 4, 5)),
                       ("shape_cd_loss", (0, 1, 2, 3, 4, 5))):
        got = getattr(tl3, name)(*(tp[i] for i in args))
        want = getattr(jl3, name)(*(jp[i] for i in args))
        assert got.shape == (2,), name
        _close(got, want, 1e-5)
    got = tl3.reassembly_loss_dict(tp[0], tp[1], tp[2], tp[3], tp[4], tp[5])
    want = jl3.reassembly_loss_dict(jp[0], jp[1], jp[2], jp[3], jp[4], jp[5])
    assert list(got) == list(want) and tl3.DEFAULT_LOSS_WEIGHTS == jl3.DEFAULT_LOSS_WEIGHTS
    for k in want:
        _close(got[k], want[k], 1e-5)


def test_shape_cd_fills_invalid_parts():
    """An invalid part's points change nothing: it is moved 1e3 away."""
    pts, t1, t2, q1, q2, valids = _poses(4)
    moved = pts.copy()
    moved[1, -1] += 5.0
    a = tl3.shape_cd_loss(*_t(pts, t1, t2, q1, q2, valids))
    b = tl3.shape_cd_loss(*_t(moved, t1, t2, q1, q2, valids))
    assert torch.equal(a, b)


def test_relative_pose_supervision_matches():
    """contact_matrix exactly (its distances are well away from the threshold
    here: the clouds are dense), the targets and the three losses."""
    rng = np.random.default_rng(5)
    b, p = 2, 4
    pts, gt_t, _, gt_q, _, valids = _poses(6, b=b, p=p, n=80)
    valids[0, -1] = False
    rot_raw = rng.standard_normal((b, p, p, 3, 3)).astype(np.float32)
    offset = rng.standard_normal((b, p, p, 3)).astype(np.float32)
    conf = (3.0 * rng.standard_normal((b, p, p))).astype(np.float32)
    jc = jl3.contact_matrix(*(jnp.asarray(x) for x in (pts, gt_q, gt_t, valids)), thresh=0.1)
    tc = tl3.contact_matrix(*_t(pts, gt_q, gt_t, valids), thresh=0.1)
    assert tc.dtype == torch.bool and np.array_equal(tc.numpy(), np.asarray(jc))
    assert 0 < int(tc.sum()) < int(tc.numel())
    for got, want in zip(tl3.relative_pose_targets(*_t(gt_q, gt_t)),
                         jl3.relative_pose_targets(jnp.asarray(gt_q), jnp.asarray(gt_t))):
        _close(got, want, 1e-6)
    got = tl3.relative_pose_loss(*_t(rot_raw, offset, conf, gt_q, gt_t), tc, torch.tensor(valids))
    want = jl3.relative_pose_loss(*(jnp.asarray(x) for x in (rot_raw, offset, conf, gt_q, gt_t)), jc,
                                  jnp.asarray(valids))
    assert set(got) == set(want) == {"rel_rot_loss", "rel_off_loss", "rel_conf_loss"}
    for k in want:
        _close(got[k], want[k], 1e-5)
