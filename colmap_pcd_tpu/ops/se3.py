"""Quaternion / SO(3) / SE(3) operations, vectorized for the device.

Conventions (match the reference scene model so model files interop):
  - quaternions are (w, x, y, z), normalized, scalar-first
    (reference: src/base/pose.h, qvec storage in src/base/image.h).
  - a pose (q, t) maps world points to camera points: x_cam = R(q) @ x_world + t
    (reference: src/base/pose.cc ComposeProjectionMatrix).
  - all functions are shape-polymorphic over leading batch dims via plain
    broadcasting; every op is jit/vmap/grad-safe (no data-dependent control flow).

The se3 tangent convention used by the bundle adjuster: delta = (omega, upsilon)
with retraction q' = exp_quat(omega) * q, t' = exp_rot(omega) @ t + upsilon.
This is a left-multiplicative update on the world-to-camera transform, which keeps
the Jacobians of projected points simple and well-conditioned around identity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def quat_normalize(q: Array) -> Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_mul(a: Array, b: Array) -> Array:
    """Hamilton product a*b, scalar-first."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q: Array) -> Array:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: Array, v: Array) -> Array:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_rotmat(q: Array) -> Array:
    """(..., 4) -> (..., 3, 3)."""
    w, x, y, z = jnp.moveaxis(quat_normalize(q), -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(R: Array) -> Array:
    """(..., 3, 3) -> (..., 4), scalar-first, w >= 0.

    Branch-free Shepperd's method: compute all four candidate quaternions and
    select the one seeded from the largest diagonal combination (stable in f32,
    vmap-safe — no data-dependent control flow).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1 + m00 + m11 + m22  # = 4w^2
    t1 = 1 + m00 - m11 - m22  # = 4x^2
    t2 = 1 - m00 + m11 - m22  # = 4y^2
    t3 = 1 - m00 - m11 + m22  # = 4z^2
    # candidate k is 4 * (component_k) * (w, x, y, z) — proportional to q,
    # numerically stable when component_k is the largest.
    cand = jnp.stack(
        [
            jnp.stack([t0, m21 - m12, m02 - m20, m10 - m01], -1),
            jnp.stack([m21 - m12, t1, m01 + m10, m02 + m20], -1),
            jnp.stack([m02 - m20, m01 + m10, t2, m12 + m21], -1),
            jnp.stack([m10 - m01, m02 + m20, m12 + m21, t3], -1),
        ],
        axis=-2,
    )
    scores = jnp.stack([t0, t1, t2, t3], -1)
    best = jnp.argmax(scores, axis=-1)
    idx = jnp.broadcast_to(best[..., None, None], best.shape + (1, 4))
    q = jnp.take_along_axis(cand, idx, axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def so3_exp_quat(omega: Array) -> Array:
    """Axis-angle (..., 3) -> unit quaternion (..., 4). Taylor-safe near 0."""
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    half = 0.5 * theta
    small = theta2 < 1e-12
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    s = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    return jnp.concatenate([w, s * omega], axis=-1)


def so3_log(q: Array) -> Array:
    """Unit quaternion (..., 4) -> axis-angle (..., 3). Taylor-safe near identity."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = jnp.sum(v * v, axis=-1, keepdims=True)
    vn = jnp.sqrt(jnp.maximum(vn2, 1e-24))
    theta = 2.0 * jnp.arctan2(vn, w)
    small = vn2 < 1e-12
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-6), theta / vn)
    return scale * v


def se3_apply(q: Array, t: Array, x: Array) -> Array:
    """x_cam = R(q) x + t, broadcasting over leading dims."""
    return quat_rotate(q, x) + t


def se3_inverse(q: Array, t: Array) -> tuple[Array, Array]:
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def se3_compose(q1: Array, t1: Array, q2: Array, t2: Array) -> tuple[Array, Array]:
    """(q1,t1) ∘ (q2,t2): first apply 2, then 1."""
    return quat_mul(q1, q2), quat_rotate(q1, t2) + t1


def se3_retract(q: Array, t: Array, delta: Array) -> tuple[Array, Array]:
    """Left-multiplicative retraction with tangent delta (..., 6) = (omega, upsilon)."""
    omega, ups = delta[..., :3], delta[..., 3:]
    dq = so3_exp_quat(omega)
    return quat_normalize(quat_mul(dq, q)), quat_rotate(dq, t) + ups


def projection_center(q: Array, t: Array) -> Array:
    """Camera center in world coordinates: C = -R^T t."""
    return -quat_rotate(quat_conj(q), t)


def euler_zyx_to_quat(roll: Array, pitch: Array, yaw: Array) -> Array:
    """Intrinsic z-y-x (yaw-pitch-roll) Euler angles -> quaternion.

    Matches the reference's pose-prior convention (roll about x, pitch about y,
    yaw about z applied in yaw->pitch->roll order; controllers/incremental_mapper.cc
    LoadPose and sfm/incremental_mapper.cc:520-543).
    """
    cr, sr = jnp.cos(roll * 0.5), jnp.sin(roll * 0.5)
    cp, sp = jnp.cos(pitch * 0.5), jnp.sin(pitch * 0.5)
    cy, sy = jnp.cos(yaw * 0.5), jnp.sin(yaw * 0.5)
    return jnp.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def quat_to_euler_zyx(q: Array) -> tuple[Array, Array, Array]:
    """Quaternion -> (roll, pitch, yaw), inverse of euler_zyx_to_quat."""
    w, x, y, z = jnp.moveaxis(quat_normalize(q), -1, 0)
    roll = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sinp = jnp.clip(2 * (w * y - z * x), -1.0, 1.0)
    pitch = jnp.arcsin(sinp)
    yaw = jnp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def angle_between(q1: Array, q2: Array) -> Array:
    """Rotation angle (radians) between two unit quaternions."""
    d = jnp.abs(jnp.sum(q1 * q2, axis=-1))
    return 2.0 * jnp.arccos(jnp.clip(d, -1.0, 1.0))
