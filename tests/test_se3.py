import jax.numpy as jnp
import numpy as np

from stereo_dso_g2o_tpu.utils import se3


def random_twists(rng, n=64, scale=1.0):
    return (rng.standard_normal((n, 6)) * scale).astype(np.float32)


def test_exp_log_roundtrip(rng):
    xi = random_twists(rng, scale=0.5)
    T = se3.se3_exp(jnp.asarray(xi))
    xi2 = se3.se3_log(T)
    np.testing.assert_allclose(np.asarray(xi2), xi, atol=2e-5)


def test_exp_small_angle(rng):
    xi = random_twists(rng, scale=1e-6)
    T = se3.se3_exp(jnp.asarray(xi))
    # first order: T ~ I + hat(xi)
    eye = np.eye(4)
    for i in range(8):
        approx = eye.copy()
        approx[:3, :3] += np.asarray(se3.hat(jnp.asarray(xi[i, 3:])))
        approx[:3, 3] += xi[i, :3]
        np.testing.assert_allclose(np.asarray(T[i]), approx, atol=1e-9)


def test_inverse_compose(rng):
    xi = random_twists(rng, scale=0.7)
    T = se3.se3_exp(jnp.asarray(xi))
    TT = se3.compose(T, se3.inverse(T))
    np.testing.assert_allclose(
        np.asarray(TT), np.broadcast_to(np.eye(4), TT.shape), atol=1e-5
    )


def test_rotation_orthonormal(rng):
    xi = random_twists(rng, scale=2.0)
    R = se3.rotation(se3.se3_exp(jnp.asarray(xi)))
    RtR = jnp.einsum("nij,nik->njk", R, R)
    np.testing.assert_allclose(
        np.asarray(RtR), np.broadcast_to(np.eye(3), RtR.shape), atol=5e-5
    )
    det = np.linalg.det(np.asarray(R))
    np.testing.assert_allclose(det, 1.0, atol=5e-5)


def test_adjoint_identity():
    """Ad(T) xi == log(T exp(xi) T^-1) to first order."""
    rng = np.random.default_rng(7)
    T = se3.se3_exp(jnp.asarray(rng.standard_normal(6).astype(np.float64) * 0.5))
    xi = jnp.asarray(rng.standard_normal(6).astype(np.float64) * 1e-4)
    lhs = se3.adjoint(T) @ xi
    rhs = se3.se3_log(T @ se3.se3_exp(xi) @ se3.inverse(T))
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), rtol=1e-4, atol=1e-10)


def test_apply(rng):
    xi = random_twists(rng, n=4, scale=0.5)
    T = se3.se3_exp(jnp.asarray(xi))
    p = jnp.asarray(rng.standard_normal((4, 3)).astype(np.float32))
    out = se3.apply(T, p)
    expect = np.einsum("nij,nj->ni", np.asarray(T[:, :3, :3]), np.asarray(p)) + np.asarray(
        T[:, :3, 3]
    )
    np.testing.assert_allclose(np.asarray(out), expect, atol=1e-5)


def test_orthonormalize_projects_onto_so3():
    """A rotation block off SO(3) by a few 1e-3 (the drift f32 pose chains
    reach when the rigid inverse squares a scale error) is projected back to
    f32 rounding; translation and exact rotations pass unchanged."""
    from stereo_dso_g2o_tpu.backend import builder, window as W

    rng = np.random.default_rng(3)
    xi = jnp.asarray(rng.normal(0, 0.3, (4, 6)), jnp.float32)
    T = se3.se3_exp(xi)
    S = jnp.eye(3) + jnp.asarray(rng.normal(0, 3e-3, (4, 3, 3)), jnp.float32)
    drifted = T.at[:, :3, :3].set(T[:, :3, :3] @ S)
    P = np.asarray(se3.orthonormalize(drifted), np.float64)
    R = P[:, :3, :3]
    err = np.abs(np.swapaxes(R, 1, 2) @ R - np.eye(3)).max()
    assert err < 1e-6, err
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-6)
    np.testing.assert_array_equal(P[:, :3, 3], np.asarray(drifted)[:, :3, 3])
    # the projection is the nearest rotation: close to the undrifted one
    np.testing.assert_allclose(R, np.asarray(T)[:, :3, :3], atol=2e-2)
    np.testing.assert_allclose(
        np.asarray(se3.orthonormalize(T)), np.asarray(T), atol=1e-6
    )
    # a keyframe's FEJ pose enters the window on SO(3)
    win = W.empty_window(2, 4, [100.0, 100.0, 50.0, 30.0])
    win = builder.insert_frame(win, 1, drifted[0], (0.0, 0.0), 1.0, 0)
    R1 = np.asarray(win.evalPT[1, :3, :3], np.float64)
    assert np.abs(R1.T @ R1 - np.eye(3)).max() < 1e-6
