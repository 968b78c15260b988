"""The port's SO(3) toolkit (``ops/so3.py``) against the JAX package's, in f32.

Tolerance: 1e-5 absolute on unit quaternions, rotation matrices, rotation
vectors, angles in radians and 6-DoF vectors (a few f32 roundings through
sqrt, atan2 and Rodrigues' series), 1e-3 on euler angles in degrees (the same
in radians times 57.3); equal rotations up to the quaternion's sign where
only the rotation is defined. Edge cases: the identity, 180° turns about
each axis and about a diagonal, and angles below the series' switch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffassemble_tpu.ops import so3 as jso3
from diffassemble_tpu_torch.ops import so3 as tso3

TOL = 1e-5


def _quats(seed, n=64):
    q = np.random.default_rng(seed).standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rmats(seed, n=64):
    return np.array(jso3.quaternion_to_matrix(jnp.asarray(_quats(seed, n))))


def _edge_rmats():
    """The identity, 180° about x, y, z and (1, 1, 0)/√2, and 1e-5 rad about z."""
    out = [np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])]
    a = np.array([1.0, 1.0, 0.0]) / np.sqrt(2)
    out.append(2 * np.outer(a, a) - np.eye(3))
    c, s = np.cos(1e-5), np.sin(1e-5)
    out.append(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]))
    return np.stack(out).astype(np.float32)


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _same_rotation(q_got: torch.Tensor, q_want, tol=TOL):
    """Unit quaternions equal up to sign."""
    g, w = q_got.numpy(), np.asarray(q_want)
    sign = np.sign(np.sum(g * w, axis=-1, keepdims=True))
    np.testing.assert_allclose(g * sign, w, rtol=0, atol=tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_quaternion_matrix_round_trip(seed):
    q = _quats(seed)
    _close(tso3.quaternion_to_matrix(torch.tensor(q)), jso3.quaternion_to_matrix(jnp.asarray(q)))
    m = _rmats(seed)
    _close(tso3.matrix_to_quaternion(torch.tensor(m)), jso3.matrix_to_quaternion(jnp.asarray(m)))
    _close(tso3.standardize_quaternion(torch.tensor(q)), jso3.standardize_quaternion(jnp.asarray(q)))


def test_matrix_to_quaternion_and_log_at_the_identity_and_180_degrees():
    m = _edge_rmats()
    q = tso3.matrix_to_quaternion(torch.tensor(m))
    _same_rotation(q, jso3.matrix_to_quaternion(jnp.asarray(m)))
    assert bool(torch.isfinite(q).all())
    _close(tso3.quaternion_to_matrix(q), m)
    # log at 180° has two answers, ±π·axis: the skew's rotation must be the input's
    log = tso3.log_rmat(torch.tensor(m))
    want = np.asarray(jso3.log_rmat(jnp.asarray(m)))
    angles = np.linalg.norm(np.asarray(jso3.skew2vec(jnp.asarray(want))), axis=-1)
    half_turn = np.isclose(angles, np.pi, atol=1e-3)
    np.testing.assert_allclose(log.numpy()[~half_turn], want[~half_turn], rtol=0, atol=TOL)
    np.testing.assert_allclose(np.abs(log.numpy()[half_turn]), np.abs(want[half_turn]), rtol=0, atol=TOL)
    _close(tso3.rotvec_to_rmat(tso3.skew2vec(log)), m)


@pytest.mark.parametrize("scale", [1.0, 1e-5, 3.0])
def test_rotvec_exp_and_log(scale):
    v = np.random.default_rng(2).standard_normal((64, 3)).astype(np.float32) * np.float32(scale)
    _close(tso3.rotvec_to_rmat(torch.tensor(v)), jso3.rotvec_to_rmat(jnp.asarray(v)))
    _close(tso3.vec2skew(torch.tensor(v)), jso3.vec2skew(jnp.asarray(v)))
    k = np.asarray(jso3.vec2skew(jnp.asarray(v)))
    _close(tso3.skew2vec(torch.tensor(k)), jso3.skew2vec(jnp.asarray(k)))
    q = _quats(3)
    _close(tso3.quaternion_to_rotvec(torch.tensor(q)), jso3.quaternion_to_rotvec(jnp.asarray(q)))
    m = _rmats(4)
    _close(tso3.rmat_to_rotvec(torch.tensor(m)), jso3.rmat_to_rotvec(jnp.asarray(m)))
    _close(tso3.log_rmat(torch.tensor(m)), jso3.log_rmat(jnp.asarray(m)))


def test_axis_angle_scale_and_lerp():
    rng = np.random.default_rng(5)
    axis = rng.standard_normal((32, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-3, 3, 32).astype(np.float32)
    _close(tso3.aa_to_rmat(torch.tensor(axis), torch.tensor(angle)),
           jso3.aa_to_rmat(jnp.asarray(axis), jnp.asarray(angle)))
    m0, m1 = _rmats(6, 32), _rmats(7, 32)
    s = rng.uniform(0, 1.5, 32).astype(np.float32)
    _close(tso3.so3_scale(torch.tensor(m0), torch.tensor(s)), jso3.so3_scale(jnp.asarray(m0), jnp.asarray(s)))
    _close(tso3.so3_lerp(torch.tensor(m0), torch.tensor(m1), torch.tensor(s)),
           jso3.so3_lerp(jnp.asarray(m0), jnp.asarray(m1), jnp.asarray(s)))


def test_geodesic_distance_and_euler():
    m0, m1 = _rmats(8), _rmats(9)
    m0[0] = m1[0]  # zero angle: the clip keeps arccos finite
    _close(tso3.geodesic_distance_rmat(torch.tensor(m0), torch.tensor(m1)),
           jso3.geodesic_distance_rmat(jnp.asarray(m0), jnp.asarray(m1)))
    q = _quats(10)
    for order in ("zyx", "xyz"):
        _close(tso3.quaternion_to_euler(torch.tensor(q), order=order),
               jso3.quaternion_to_euler(jnp.asarray(q), order=order), tol=1e-3)
        _close(tso3.quaternion_to_euler(torch.tensor(q), order=order, degrees=False),
               jso3.quaternion_to_euler(jnp.asarray(q), order=order, degrees=False))
    with pytest.raises(NotImplementedError):
        tso3.quaternion_to_euler(torch.tensor(q), order="zxz")


def test_sixdof_and_orthogonalise():
    d6 = np.random.default_rng(11).standard_normal((32, 6)).astype(np.float32)
    _close(tso3.sixdof_to_matrix(torch.tensor(d6)), jso3.sixdof_to_matrix(jnp.asarray(d6)))
    m = _rmats(12, 32)
    _close(tso3.matrix_to_sixdof(torch.tensor(m)), jso3.matrix_to_sixdof(jnp.asarray(m)))
    noisy = m + 0.05 * np.random.default_rng(13).standard_normal(m.shape).astype(np.float32)
    _close(tso3.orthogonalise(torch.tensor(noisy)), jso3.orthogonalise(jnp.asarray(noisy)))


def test_random_quaternion_takes_a_generator():
    a = tso3.random_quaternion(torch.Generator().manual_seed(0), (5, 3))
    b = tso3.random_quaternion(torch.Generator().manual_seed(0), (5, 3))
    assert a.shape == (5, 3, 4) and torch.equal(a, b)
    torch.testing.assert_close(torch.linalg.vector_norm(a, dim=-1), torch.ones(5, 3), rtol=0, atol=1e-6)


def test_f32_matmuls_restores_the_process_setting():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with tso3.f32_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
