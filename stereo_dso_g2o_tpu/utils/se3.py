"""SE(3) / SO(3) Lie-group operations in pure JAX.

Replaces the reference's vendored Sophus (thirdparty/Sophus/sophus/se3.hpp)
for the pose representation used everywhere: left-multiplicative twist updates
`T <- exp(xi) * T` with xi = (trans, rot) ordered as in the reference state
vector (translation first; cf. dso_g2o_vertex.cpp:15-18 uses Sophus order
(trans, rot) in SE3::exp).

All functions are batched: inputs may have arbitrary leading dimensions; the
pose is a 4x4 homogeneous matrix. Taylor fallbacks keep everything smooth and
jit/vmap/grad-safe near theta=0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w):
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w):
    """Rodrigues. w: (..., 3) -> R: (..., 3, 3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallback
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R):
    """R: (..., 3, 3) -> w: (..., 3). Stable for theta in [0, pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # vee of (R - R^T)/2
    w = 0.5 * jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)
    small = theta < 1e-4
    scale = jnp.where(small, 1.0 + theta * theta / 6.0, theta / jnp.where(small, 1.0, sin_t + _EPS))
    # near theta=pi the vee formula degrades; DSO never operates there
    # (frame-to-frame increments are small), so we accept it.
    return w * scale[..., None]


def se3_exp(xi):
    """xi: (..., 6) with (trans[3], rot[3]) Sophus ordering -> T: (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    C = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (1.0 - A) / (theta2 + _EPS * _EPS),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return rt_to_mat(R, t)


def se3_log(T):
    """T: (..., 4, 4) -> xi: (..., 6) = (trans, rot)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    D = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * B)) / (theta2 + _EPS * _EPS),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = eye - 0.5 * W + D[..., None, None] * W2
    rho = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([rho, w], axis=-1)


def rt_to_mat(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = R.shape[:-2]
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def identity(dtype=jnp.float32, batch=()):
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), batch + (4, 4))


def inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def orthonormalize(T, iters: int = 2):
    """Project T's rotation block back onto SO(3) (Newton-Schulz polar
    iteration R <- R (3I - R^T R) / 2, quadratic near an orthonormal R).

    Poses built from f32 products drift off SO(3) by rounding, and the
    rigid inverse (R^T for R^-1) turns a scale error S into S^2 on every
    pass through the motion model, so an unprojected drift compounds from
    keyframe to keyframe."""
    R = T[..., :3, :3]
    eye = jnp.eye(3, dtype=T.dtype)
    for _ in range(iters):
        R = R @ (1.5 * eye - 0.5 * jnp.swapaxes(R, -1, -2) @ R)
    return T.at[..., :3, :3].set(R)


def compose(A, B):
    return A @ B


def rotation(T):
    return T[..., :3, :3]


def translation(T):
    return T[..., :3, 3]


def adjoint(T):
    """Adjoint of SE(3) for (trans, rot)-ordered twists: (..., 6, 6).

    Ad(T) = [[R, t^ R], [0, R]] — maps body twists between frames; used to
    build the host/target adjoint matrices of the energy functional
    (EnergyFunctional.cpp:41-119 setAdjointsF).
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = hat(t) @ R
    batch = R.shape[:-2]
    Ad = jnp.zeros(batch + (6, 6), dtype=T.dtype)
    Ad = Ad.at[..., :3, :3].set(R)
    Ad = Ad.at[..., :3, 3:].set(tR)
    Ad = Ad.at[..., 3:, 3:].set(R)
    return Ad


def apply(T, p):
    """Transform points. T: (..., 4, 4), p: (..., 3) -> (..., 3)."""
    return jnp.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]
