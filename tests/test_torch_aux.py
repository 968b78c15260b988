"""The port's helper modules against the JAX package's, on the CPU:
``ops/rotation3d.py``, ``ops/distributions.py`` and
``train/schedules_lr.py`` (the data copies are in ``test_torch_data.py``).

Deterministic functions take the same numpy inputs in both packages:
rotations and affine maps within 1e-5 (float32 products in another order),
MMD² within 1e-5 relative plus 1e-7, the LR schedule within 1e-6 relative
(both compute in float32). The samplers draw from a ``torch.Generator``
where the JAX package splits a key, so they are held by their properties
(shapes, unit quaternions, rotation matrices) and by the unbiased MMD²
between 1000 of the port's draws and 1000 of the JAX package's, which must
lie below ``MMD_SAME_LAW`` (0.01): its spread between two samples of one law
is O(1/n) with a kernel bounded by 1, and each case shows a sample of
another law lying above 5× that threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.ops import distributions as jdist
from diffassemble_tpu.ops import rotation3d as jrot
from diffassemble_tpu.ops.igso3 import build_igso3_inverse_cdf as jbuild
from diffassemble_tpu.train.schedules_lr import cosine_annealing_warmup_restarts as jschedule
from diffassemble_tpu_torch.ops import AffineT, Rotation3D, bingham_sample, igso3xr3_sample, mmd_rbf, mmd_rotation
from diffassemble_tpu_torch.ops.igso3 import build_igso3_inverse_cdf
from diffassemble_tpu_torch.ops.so3 import random_quaternion
from diffassemble_tpu_torch.train import cosine_annealing_warmup_restarts

MMD_SAME_LAW = 0.01
N_DRAWS = 1000


def _quats(seed, n):
    q = np.random.default_rng(seed).standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("rot_type", ["quat", "rmat", "6d", "axis_angle"])
def test_rotation3d_conversions_match_jax(rot_type):
    q = _quats(0, 16)
    base_j = jrot.Rotation3D(jnp.asarray(q), "quat")
    rot = np.asarray(base_j.convert(rot_type).rot)
    j, t = jrot.Rotation3D(jnp.asarray(rot), rot_type), Rotation3D(torch.tensor(rot), rot_type)
    assert t.rot_type == rot_type and tuple(t.shape) == tuple(j.shape)
    for fn in ("to_quat", "to_rmat", "to_6d", "to_axis_angle"):
        _close(getattr(t, fn)(), getattr(j, fn)())
    _close(t.to_euler(), j.to_euler(), atol=1e-3)  # degrees
    for other in ("quat", "rmat", "6d", "axis_angle"):
        _close(t.convert(other).rot, j.convert(other).rot)


def test_rotation3d_apply_compose_inverse_match_jax():
    qa, qb = _quats(1, 6), _quats(2, 6)
    pts = np.random.default_rng(3).standard_normal((6, 10, 3)).astype(np.float32)
    ja, jb = jrot.Rotation3D(jnp.asarray(qa)), jrot.Rotation3D(jnp.asarray(qb))
    ta, tb = Rotation3D(torch.tensor(qa)), Rotation3D(torch.tensor(qb))
    _close(ta.apply_rotation(torch.tensor(pts)), ja.apply_rotation(jnp.asarray(pts)))
    _close(ta.compose(tb).to_rmat(), ja.compose(jb).to_rmat())
    _close(ta.inverse().to_rmat(), ja.inverse().to_rmat())
    _close(ta.inverse().apply_rotation(ta.apply_rotation(torch.tensor(pts))), pts, atol=1e-4)


def test_rotation3d_sanitizes_zero_quats_and_reshapes():
    q = np.concatenate([np.zeros((2, 4), np.float32), _quats(4, 4)])
    j, t = jrot.Rotation3D(jnp.asarray(q)), Rotation3D(torch.tensor(q))
    _close(t.rot, j.rot, atol=1e-6)
    assert torch.equal(t.rot[:2], torch.tensor([[1.0, 0, 0, 0]] * 2))
    r = Rotation3D(torch.tensor(q), "quat").convert("rmat")
    assert tuple(r.reshape(2, 3).shape) == (2, 3, 3, 3) and tuple(r[1:3].shape) == (2, 3, 3)
    assert r.to("cpu").rot_type == "rmat" and "rmat" in repr(r)
    with pytest.raises(ValueError):
        Rotation3D(torch.zeros(3), "euler")


def test_affine_t_matches_jax():
    rng = np.random.default_rng(5)
    rots = [np.asarray(jrot.Rotation3D(jnp.asarray(_quats(s, 5))).to_rmat()) for s in (6, 7)]
    shifts = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(2)]
    pts = rng.standard_normal((5, 8, 3)).astype(np.float32)
    ja, jb = (jdist.AffineT(jnp.asarray(r), jnp.asarray(s)) for r, s in zip(rots, shifts))
    ta, tb = (AffineT(torch.tensor(r), torch.tensor(s)) for r, s in zip(rots, shifts))
    assert tuple(ta.shape) == tuple(ja.shape) == (5,)
    _close(ta.apply(torch.tensor(pts)), ja.apply(jnp.asarray(pts)))
    for got, want in ((ta.compose(tb), ja.compose(jb)), (ta.inverse(), ja.inverse())):
        _close(got.rot, want.rot)
        _close(got.shift, want.shift)
    ident = ta.compose(ta.inverse())
    _close(ident.rot, np.broadcast_to(np.eye(3), (5, 3, 3)))
    _close(ident.shift, np.zeros((5, 3)))


@pytest.mark.parametrize("bandwidth", [None, 0.7])
def test_mmd_matches_jax_on_the_same_samples(bandwidth):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((60, 3)).astype(np.float32)
    y = (rng.standard_normal((41, 3)) + 0.5).astype(np.float32)  # odd pooled count: the median is one entry
    z = rng.standard_normal((40, 3)).astype(np.float32)  # even pooled count: the mean of two
    for a, b in ((x, y), (x, z)):
        want = float(jdist.mmd_rbf(jnp.asarray(a), jnp.asarray(b), bandwidth))
        got = float(mmd_rbf(torch.tensor(a), torch.tensor(b), bandwidth))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    q1, q2 = _quats(9, 50), _quats(10, 30)
    want = float(jdist.mmd_rotation(jnp.asarray(q1), jnp.asarray(q2), bandwidth))
    np.testing.assert_allclose(float(mmd_rotation(torch.tensor(q1), torch.tensor(q2), bandwidth)), want,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(mmd_rotation(torch.tensor(q1), torch.tensor(-q1))),
                               float(mmd_rotation(torch.tensor(q1), torch.tensor(q1))), atol=1e-6)


def test_lr_schedule_matches_jax_across_three_cycles():
    kw = dict(first_cycle_steps=100, cycle_mult=2.0, max_lr=1e-3, min_lr=1e-5, warmup_steps=10, gamma=0.5)
    j, t = jschedule(**kw), cosine_annealing_warmup_restarts(**kw)
    steps = list(range(0, 700, 3)) + [99, 100, 109, 110, 299, 300, 310, 699, 700, 701]  # cycles at 0, 100, 300
    got = np.array([t(s) for s in steps])
    want = np.array([float(j(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert t(110) > t(99) and t(310) > t(299)  # each restart warms up to its decayed peak
    np.testing.assert_allclose([t(110), t(310)], [0.5e-3, 0.25e-3], rtol=0.01)
    lambda_lr = torch.optim.lr_scheduler.LambdaLR(torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1e-3),
                                                  lambda s: t(s) / 1e-3)
    assert lambda_lr.get_last_lr() == [pytest.approx(t(0))]


def _jax_igso3xr3(table, t, shift_scale, mean=None):
    s = jdist.igso3xr3_sample(jax.random.PRNGKey(11), jnp.asarray(table), jnp.asarray(t), shift_scale=shift_scale,
                              mean=mean)
    return np.asarray(s.rot), np.asarray(s.shift)


def test_igso3xr3_sample_properties_and_law():
    eps = np.array([0.3, 0.8])
    table = torch.as_tensor(build_igso3_inverse_cdf(eps))
    assert np.array_equal(table.numpy(), np.asarray(jbuild(eps)))
    t = torch.tensor(np.random.default_rng(12).integers(0, 2, N_DRAWS))
    s = igso3xr3_sample(torch.Generator().manual_seed(13), table, t, shift_scale=0.5)
    assert s.rot.shape == (N_DRAWS, 3, 3) and s.shift.shape == (N_DRAWS, 3)
    _close(s.rot @ s.rot.transpose(-1, -2), np.broadcast_to(np.eye(3), (N_DRAWS, 3, 3)), atol=1e-5)
    _close(torch.linalg.det(s.rot), np.ones(N_DRAWS), atol=1e-5)
    mean = AffineT(s.rot[:1].expand(N_DRAWS, 3, 3), torch.ones(N_DRAWS, 3))
    moved = igso3xr3_sample(torch.Generator().manual_seed(13), table, t, shift_scale=0.5, mean=mean)
    _close(moved.rot, mean.rot @ s.rot)
    _close(moved.shift, s.shift + 1.0)
    rot_j, shift_j = _jax_igso3xr3(table.numpy(), t.numpy(), 0.5)
    same_rot = float(mmd_rbf(s.rot.reshape(-1, 9), torch.tensor(rot_j).reshape(-1, 9)))
    same_shift = float(mmd_rbf(s.shift, torch.tensor(shift_j)))
    # another law: the JAX package's draws about a mean a quarter turn about z and 1 along each axis away
    quarter = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    other_rot, other_shift = _jax_igso3xr3(table.numpy(), t.numpy(), 0.5, jdist.AffineT(
        jnp.broadcast_to(jnp.asarray(quarter), (N_DRAWS, 3, 3)), jnp.ones((N_DRAWS, 3))))
    assert same_rot < MMD_SAME_LAW and same_shift < MMD_SAME_LAW, (same_rot, same_shift)
    assert float(mmd_rbf(s.rot.reshape(-1, 9), torch.tensor(other_rot).reshape(-1, 9))) > 5 * MMD_SAME_LAW
    assert float(mmd_rbf(s.shift, torch.tensor(other_shift))) > 5 * MMD_SAME_LAW


@pytest.mark.parametrize("diag", [(0.0, 1.0, 5.0, 5.0), (0.0, 0.0, 20.0, 40.0)])
def test_bingham_sample_properties_and_law(diag):
    A = -np.diag(np.asarray(diag, dtype=np.float32))
    q = bingham_sample(torch.Generator().manual_seed(14), torch.tensor(A), N_DRAWS)
    assert q.shape == (N_DRAWS, 4)
    _close(torch.linalg.vector_norm(q, dim=-1), np.ones(N_DRAWS))
    q_j = np.asarray(jdist.bingham_sample(jax.random.PRNGKey(15), jnp.asarray(A), N_DRAWS))
    same = float(mmd_rotation(q, torch.tensor(q_j)))
    uniform = random_quaternion(torch.Generator().manual_seed(16), (N_DRAWS,))
    assert same < MMD_SAME_LAW, same
    assert float(mmd_rotation(q, uniform)) > 5 * MMD_SAME_LAW
