"""Batched SO(3)/SE(3) Lie-group operations.

Batched replacement for the reference's Sophus usage
(/root/reference/LocUtils/include/LocUtils/common/eigen_types.h:12-107 and
math_utils.h SO3 exp/log helpers). Everything here is a pure jax function over
float arrays, closed-form (no iterative routines), broadcastable over leading
batch dimensions, and safe at the theta -> 0 singularity via Taylor fallbacks
so it can be differentiated and `vmap`ed/`scan`ed freely.

Conventions (matching the reference):
  * rotations are 3x3 matrices (row-major), acting on column vectors.
  * `so3_exp` is the Rodrigues formula; `se3` poses are (R, t) pairs where
    `apply(R, t, x) = R @ x + t`.
  * retraction used by all GN solvers is the *right* perturbation on SO3 with
    a plain additive translation update, exactly the reference solver update
    `pose.so3() * SO3::exp(dx[0:3]); pose.translation() += dx[3:6]`
    (icp_registration.cpp:288-289, ndt_registration.cpp:355-356).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of w: (..., 3) -> (..., 3, 3)."""
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


def vee(W: jax.Array) -> jax.Array:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues formula, (..., 3) -> (..., 3, 3); Taylor-safe near 0.

    AD-safe: unselected `where` branches use unit-clamped denominators so
    reverse/forward-mode never sees inf * 0 = NaN (the pose graph
    differentiates through this at exactly theta = 0)."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta_safe = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta_safe) / theta_safe)
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta_safe)) / theta2_safe)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: jax.Array) -> jax.Array:
    """Log map (..., 3, 3) -> (..., 3); Taylor-safe near identity and pi.

    Uses theta = arctan2(|antisym|, cos) — better conditioned than arccos
    near identity and AD-safe with the unit-clamped-denominator pattern
    (arccos'(1) is infinite, which poisoned pose-graph Jacobians)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # Antisymmetric part gives axis*sin(theta)
    w_sin = 0.5 * vee(R - jnp.swapaxes(R, -1, -2))
    sin2 = jnp.sum(w_sin * w_sin, axis=-1)
    # near identity: sin AND cos small-angle; near pi sin is also tiny but
    # cos_t < 0, handled by the w_pi branch below
    small = (sin2 < 1e-12) & (cos_t > 0)
    sin2_safe = jnp.where(small, 1.0, sin2)
    sin_t = jnp.sqrt(sin2_safe)
    theta_gen = jnp.arctan2(sin_t, cos_t)
    theta = jnp.where(small, jnp.sqrt(jnp.maximum(sin2, 0.0)), theta_gen)
    # Near theta=0: log(R) ~ vee(R - R^T)/2 * (1 + theta^2/6)
    scale_small = 1.0 + sin2 / 6.0
    scale_gen = theta_gen / sin_t
    scale = jnp.where(small, scale_small, scale_gen)
    w_gen = w_sin * scale[..., None]

    # Near theta=pi the antisymmetric part vanishes; recover axis from the
    # symmetric part: R ~ I + 2*ww^T - ... => diag gives |axis| components.
    near_pi = theta > 3.0
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_sq = jnp.maximum((diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + _EPS), 0.0)
    axis_abs = jnp.sqrt(axis_sq)
    # Fix signs using the off-diagonal symmetric entries and w_sin hints
    sign_hint = jnp.where(jnp.abs(w_sin) > 1e-6, jnp.sign(w_sin), 1.0)
    # Use products R[i,j]+R[j,i] = 2*(1-cos)*ai*aj to repair relative signs
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    ax = axis_abs[..., 0] * sign_hint[..., 0]
    ay = jnp.where(jnp.abs(sxy) > 1e-6, jnp.sign(sxy) * jnp.sign(ax), sign_hint[..., 1]) * axis_abs[..., 1]
    az = jnp.where(jnp.abs(sxz) > 1e-6, jnp.sign(sxz) * jnp.sign(ax), sign_hint[..., 2]) * axis_abs[..., 2]
    w_pi = jnp.stack([ax, ay, az], axis=-1) * theta[..., None]

    return jnp.where(near_pi[..., None], w_pi, w_gen)


# ---------------------------------------------------------------------------
# SE(3) as (R, t)
# ---------------------------------------------------------------------------

def se3_identity(dtype=jnp.float32):
    return jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype=dtype)


def se3_apply(R: jax.Array, t: jax.Array, pts: jax.Array) -> jax.Array:
    """Transform points: (..., 3, 3), (..., 3), (N, 3) -> (N, 3)."""
    return pts @ jnp.swapaxes(R, -1, -2) + t


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): first apply b, then a."""
    return Ra @ Rb, ta + jnp.einsum("...ij,...j->...i", Ra, tb)


def se3_inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def se3_exp(xi: jax.Array):
    """Exp map of (..., 6) twist [w, v] (rotation-first, matching the solver
    state layout dx=[dtheta, dt]) -> (R, t). Uses the full SE(3) V matrix."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / (theta2_safe * theta))
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, jnp.einsum("...ij,...j->...i", V, v)


def so3_jl_inv(w: jax.Array) -> jax.Array:
    """Closed-form inverse LEFT Jacobian of SO(3) (= V^{-1} of the SE(3)
    exp), (..., 3) -> (..., 3, 3); Taylor-safe near 0."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    # V^{-1} = I - W/2 + (1/theta^2 - (1+cos)/(2 theta sin)) W^2
    half_theta = 0.5 * theta
    cot = jnp.cos(half_theta) / jnp.sin(half_theta)  # theta >= 1 when "small"
    coef = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0,
                     (1.0 - half_theta * cot) / theta2_safe)
    return eye - 0.5 * W + coef[..., None, None] * W2


def se3_log(R: jax.Array, t: jax.Array) -> jax.Array:
    """Log map -> (..., 6) twist [w, v]."""
    w = so3_log(R)
    v = jnp.einsum("...ij,...j->...i", so3_jl_inv(w), t)
    return jnp.concatenate([w, v], axis=-1)


def se3_adjoint(R: jax.Array, t: jax.Array) -> jax.Array:
    """6x6 Ad(T) for the [w, v] twist ordering:
    Ad(T) [w; v] = [R w; hat(t) R w + R v], satisfying
    T Exp(xi) T^{-1} = Exp(Ad(T) xi)."""
    Z = jnp.zeros_like(R)
    top = jnp.concatenate([R, Z], axis=-1)
    bot = jnp.concatenate([hat(t) @ R, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _se3_Q(w: jax.Array, v: jax.Array) -> jax.Array:
    """Barfoot's Q matrix (State Estimation for Robotics eq. 7.86b, with
    rho=v, phi=w), the translation-rotation coupling block of the SE(3)
    left Jacobian. Taylor-safe near theta = 0."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    s, c = jnp.sin(theta), jnp.cos(theta)
    c1 = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                   (theta - s) / (theta2_safe * theta))
    c2 = jnp.where(small, 1.0 / 24.0 - theta2 / 720.0,
                   (theta2 + 2.0 * c - 2.0) / (2.0 * theta2_safe ** 2))
    c3 = jnp.where(small, 1.0 / 120.0 - theta2 / 2520.0,
                   (2.0 * theta - 3.0 * s + theta * c)
                   / (2.0 * theta2_safe ** 2 * theta))
    W = hat(w)
    V_ = hat(v)
    WV, VW = W @ V_, V_ @ W
    WVW = WV @ W
    c1 = c1[..., None, None]
    c2 = c2[..., None, None]
    c3 = c3[..., None, None]
    return (0.5 * V_
            + c1 * (WV + VW + W @ VW)
            + c2 * (W @ WV + VW @ W - 3.0 * WVW)
            + c3 * (WVW @ W + W @ WVW))


def se3_jl_inv(xi: jax.Array) -> jax.Array:
    """Closed-form inverse LEFT Jacobian of SE(3), (..., 6) -> (..., 6, 6),
    twist ordering [w, v]:
        Jl(xi)     = [[J, 0], [Q, J]]   (J = SO(3) left Jacobian)
        Jl^{-1}    = [[J^{-1}, 0], [-J^{-1} Q J^{-1}, J^{-1}]]
    The exact derivative d/d_eps Log(Exp(eps) Exp(xi)) at eps = 0 — what the
    pose-graph edge linearization needs in closed form instead of pushing 6
    jacfwd tangents through compose/inverse/log (the dominant XLA compile
    cost of the PGO program)."""
    w, v = xi[..., :3], xi[..., 3:]
    Jinv = so3_jl_inv(w)
    Q = _se3_Q(w, v)
    JQJ = -Jinv @ Q @ Jinv
    Z = jnp.zeros_like(Jinv)
    top = jnp.concatenate([Jinv, Z], axis=-1)
    bot = jnp.concatenate([JQJ, Jinv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_jr_inv(xi: jax.Array) -> jax.Array:
    """Closed-form inverse RIGHT Jacobian of SE(3): Jr^{-1}(xi) =
    Jl^{-1}(-xi) — the exact derivative d/d_eps Log(Exp(xi) Exp(eps))
    at eps = 0."""
    return se3_jl_inv(-xi)


def se3_retract(R, t, dx):
    """The reference GN update: right-multiply SO3 by exp(dx[:3]), add dx[3:]
    to translation (icp_registration.cpp:288-289)."""
    return R @ so3_exp(dx[..., :3]), t + dx[..., 3:]


def so3_renormalize(R: jax.Array) -> jax.Array:
    """Project a near-rotation matrix back onto SO(3) (two Newton-Schulz
    polar iterations, quadratic convergence for ||R^T R - I|| < 1).

    float32 retraction chains (R @ exp(dx) per GN iteration) drift off the
    manifold at ~1e-7 per compose. That seed is harmless per solve, but
    the odometry-only constant-velocity prediction R * last^-1 * R FEEDS
    THE DEFECT BACK and amplifies it ~2.4x per frame (measured on an
    exploring-corridor drive: orthonormality error 7e-9 at frame 8 ->
    0.11 at frame 27 -> solver divergence -> NaN poses; the reference
    never hits this because Eigen/Sophus SO3 re-normalizes its quaternion
    storage on construction, sophus/so3.hpp). Every matcher projects its
    output rotation once per solve, which pins the steady-state defect at
    the single-solve level (~1e-7) for any run length. Supports batched
    (..., 3, 3) input."""
    eye = jnp.eye(3, dtype=R.dtype)
    for _ in range(2):
        RtR = jnp.swapaxes(R, -1, -2) @ R
        R = 0.5 * (R @ (3.0 * eye - RtR))
    return R


def se3_retract_full(R, t, dx):
    """Full right-multiplicative retraction T * Exp(dx) (used by the pose
    graph, whose residual is differentiated w.r.t. this perturbation)."""
    dR, dt = se3_exp(dx)
    return se3_compose(R, t, dR, dt)


def se3_matrix(R, t):
    """(R, t) -> 4x4 homogeneous matrix."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    M = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    M = M.at[..., :3, :3].set(R)
    M = M.at[..., :3, 3].set(t)
    M = M.at[..., 3, 3].set(1.0)
    return M


def se3_from_matrix(M):
    return M[..., :3, :3], M[..., :3, 3]


# ---------------------------------------------------------------------------
# Quaternions / Euler (for I/O: TUM trajectories, extrinsic configs)
# ---------------------------------------------------------------------------

def quat_from_rotm(R: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate constructions; pick the numerically best.
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, _EPS)) * 0.5
    q0 = jnp.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], axis=-1)
    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 0.5
    q1 = jnp.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], axis=-1)
    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, _EPS)) * 0.5
    q2 = jnp.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], axis=-1)
    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, _EPS)) * 0.5
    q3 = jnp.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], axis=-1)
    cand = jnp.stack([q0, q1, q2, q3], axis=-2)  # (..., 4, 4)
    scores = jnp.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], axis=-1)
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cand, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def rotm_from_quat(q: jax.Array) -> jax.Array:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def quat_slerp(q0: jax.Array, q1: jax.Array, alpha) -> jax.Array:
    """Normalized spherical lerp used by the measurement synchronizer
    (measure_sync.cpp quaternion interpolation)."""
    dot = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(dot < 0, -q1, q1)
    q = q0 + (q1 - q0) * alpha
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def rotm_from_rpy(roll, pitch, yaw):
    """ZYX Euler (applied Rz @ Ry @ Rx) -> rotation matrix, matching
    math::RpyToRotM2 used for the T_imu_lidar extrinsic (lio.cpp:63-66)."""
    roll, pitch, yaw = (jnp.asarray(v, dtype=jnp.float32) for v in (roll, pitch, yaw))
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    Rz = jnp.stack([
        jnp.stack([cy, -sy, jnp.zeros_like(cy)], -1),
        jnp.stack([sy, cy, jnp.zeros_like(cy)], -1),
        jnp.stack([jnp.zeros_like(cy), jnp.zeros_like(cy), jnp.ones_like(cy)], -1)], -2)
    Ry = jnp.stack([
        jnp.stack([cp, jnp.zeros_like(cp), sp], -1),
        jnp.stack([jnp.zeros_like(cp), jnp.ones_like(cp), jnp.zeros_like(cp)], -1),
        jnp.stack([-sp, jnp.zeros_like(cp), cp], -1)], -2)
    Rx = jnp.stack([
        jnp.stack([jnp.ones_like(cr), jnp.zeros_like(cr), jnp.zeros_like(cr)], -1),
        jnp.stack([jnp.zeros_like(cr), cr, -sr], -1),
        jnp.stack([jnp.zeros_like(cr), sr, cr], -1)], -2)
    return Rz @ Ry @ Rx


# ---------------------------------------------------------------------------
# SE(2) (for the 2D mapping stack)
# ---------------------------------------------------------------------------

def se2_apply(theta, t, pts):
    """(...,), (..., 2), (N, 2) -> rotated+translated points."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    x = c[..., None] * pts[..., 0] - s[..., None] * pts[..., 1]
    y = s[..., None] * pts[..., 0] + c[..., None] * pts[..., 1]
    return jnp.stack([x, y], axis=-1) + t[..., None, :]


def se2_compose(th_a, t_a, th_b, t_b):
    c, s = jnp.cos(th_a), jnp.sin(th_a)
    tx = t_a[..., 0] + c * t_b[..., 0] - s * t_b[..., 1]
    ty = t_a[..., 1] + s * t_b[..., 0] + c * t_b[..., 1]
    return th_a + th_b, jnp.stack([tx, ty], axis=-1)


def se2_inverse(theta, t):
    c, s = jnp.cos(theta), jnp.sin(theta)
    tx = -(c * t[..., 0] + s * t[..., 1])
    ty = -(-s * t[..., 0] + c * t[..., 1])
    return -theta, jnp.stack([tx, ty], axis=-1)


def wrap_angle(a):
    """Wrap angle(s) to (-pi, pi], the reference's KeepAngleInPI."""
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))
