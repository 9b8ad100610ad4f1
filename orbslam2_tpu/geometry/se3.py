"""SO(3)/SE(3) Lie-group utilities (batch-friendly, jit-safe).

JAX-native replacement for the reference's g2o `SE3Quat`
(Thirdparty/g2o/g2o/types/se3quat.h) and `Converter` helpers
(src/Converter.cpp). All functions are pure jnp, broadcast over leading batch
dimensions, and use Taylor fallbacks near theta=0 so gradients stay finite.

Convention: poses are world->camera transforms Tcw = (R, t) with
x_cam = R @ x_world + t, matching the reference (src/Frame.cpp:276-305).
A pose is stored as a (..., 3, 4) array [R | t].
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
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
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R):
    """(..., 3, 3) rotation -> (..., 3) axis-angle."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # vee of the antisymmetric part
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)
    # theta / (2 sin theta), Taylor near 0. Near pi the vee formula degrades;
    # SLAM increments are small so the pi branch uses a clamped denominator.
    scale = jnp.where(
        jnp.abs(sin_t) > 1e-5,
        theta / (2.0 * jnp.where(jnp.abs(sin_t) > 1e-5, sin_t, 1.0)),
        0.5 + theta * theta / 12.0,
    )
    return v * scale[..., None]


def _so3_left_jacobian(w):
    """Left Jacobian J_l of SO(3): exp((Jl v)^) translation coupling."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = jnp.where(
        theta2 > _EPS, (theta - jnp.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b * W + c * W2


def se3_exp(xi):
    """(..., 6) twist [v, w] -> (..., 3, 4) transform [R | t].

    Uses t = J_l(w) v, the exact SE(3) exponential.
    """
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return jnp.concatenate([R, t[..., None]], axis=-1)


def se3_log(T):
    """(..., 3, 4) -> (..., 6) twist [v, w]."""
    R, t = T[..., :3], T[..., 3]
    w = so3_log(R)
    Jl = _so3_left_jacobian(w)
    v = jnp.linalg.solve(Jl, t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def make_T(R, t):
    return jnp.concatenate([R, t[..., None]], axis=-1)


def rot(T):
    return T[..., :3]


def trans(T):
    return T[..., 3]


def compose(Ta, Tb):
    """Ta @ Tb for (..., 3, 4) transforms."""
    Ra, ta = rot(Ta), trans(Ta)
    Rb, tb = rot(Tb), trans(Tb)
    R = Ra @ Rb
    t = (Ra @ tb[..., None])[..., 0] + ta
    return make_T(R, t)


def inverse(T):
    R, t = rot(T), trans(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T, pts):
    """Apply (..., 3, 4) to (..., N, 3) points -> (..., N, 3)."""
    R, t = rot(T), trans(T)
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def retract(T, xi):
    """Left-multiplicative update exp(xi) @ T — the BA local parameterization
    (matches g2o VertexSE3Expmap::oplusImpl semantics)."""
    return compose(se3_exp(xi), T)


def identity(dtype=jnp.float32):
    return jnp.concatenate([jnp.eye(3, dtype=dtype), jnp.zeros((3, 1), dtype=dtype)], axis=-1)


def to_4x4(T):
    last = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), T.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([T, last], axis=-2)


def camera_center(Tcw):
    """Ow = -R^T t, the camera center in world coords (src/Frame.cpp:287-305)."""
    R, t = rot(Tcw), trans(Tcw)
    return -(jnp.swapaxes(R, -1, -2) @ t[..., None])[..., 0]


def quat_to_R(q):
    """(..., 4) quaternion (x, y, z, w) -> rotation matrix (TUM convention)."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def R_to_quat(R):
    """(..., 3, 3) -> (..., 4) quaternion (x, y, z, w), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Branch-free Shepperd: compute all four candidates, pick the best-conditioned.
    qw2 = jnp.maximum(0.0, 1.0 + tr) * 0.25
    qx2 = jnp.maximum(0.0, 1.0 + m00 - m11 - m22) * 0.25
    qy2 = jnp.maximum(0.0, 1.0 - m00 + m11 - m22) * 0.25
    qz2 = jnp.maximum(0.0, 1.0 - m00 - m11 + m22) * 0.25
    candidates = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    case = jnp.argmax(candidates, axis=-1)

    def build(case_idx):
        s_w = 4.0 * jnp.sqrt(qw2 + _EPS)
        s_x = 4.0 * jnp.sqrt(qx2 + _EPS)
        s_y = 4.0 * jnp.sqrt(qy2 + _EPS)
        s_z = 4.0 * jnp.sqrt(qz2 + _EPS)
        q_from_w = jnp.stack([(m21 - m12) / s_w, (m02 - m20) / s_w, (m10 - m01) / s_w, s_w * 0.25], -1)
        q_from_x = jnp.stack([s_x * 0.25, (m01 + m10) / s_x, (m02 + m20) / s_x, (m21 - m12) / s_x], -1)
        q_from_y = jnp.stack([(m01 + m10) / s_y, s_y * 0.25, (m12 + m21) / s_y, (m02 - m20) / s_y], -1)
        q_from_z = jnp.stack([(m02 + m20) / s_z, (m12 + m21) / s_z, s_z * 0.25, (m10 - m01) / s_z], -1)
        stacked = jnp.stack([q_from_w, q_from_x, q_from_y, q_from_z], axis=-2)
        return jnp.take_along_axis(stacked, case_idx[..., None, None], axis=-2)[..., 0, :]

    q = build(case)
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # canonical sign
    return q * jnp.where(q[..., 3:4] < 0, -1.0, 1.0)
