"""18-dim error-state Kalman filter, static IMU initializer, IMU integrator.

Rebuild of the reference ESKF
(/root/reference/LocUtils/include/LocUtils/model/eskf/eskf.hpp), the static
initializer (model/static_init/static_imu_init.cpp) and the dead-reckoning
integrator (model/integration/imu_integration.cpp).

The C++ stateful class becomes a pure `(state, measurement) -> state`
function pair (`predict`, `observe_se3`) over an `EskfState` pytree, so a
whole IMU packet propagates through `lax.scan` in one fused kernel
(`predict_scan`), exactly the "ESKF as a scan-compatible function" design of
SURVEY.md section 7. State order matches the book/reference: p, v, R, bg,
ba, g (eskf.hpp:54-71).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import lie

DEG2RAD = jnp.pi / 180.0


@dataclasses.dataclass(frozen=True)
class EskfOptions:
    """Mirror of EskfOptions (eskf.hpp:15-48). Noise terms are discrete-time
    (the reference comments they are NOT multiplied by dt, eskf.hpp:21)."""

    imu_dt: float = 0.01
    gyro_var: float = 1e-5
    acce_var: float = 1e-2
    bias_gyro_var: float = 1e-6
    bias_acce_var: float = 1e-4
    gnss_pos_noise: float = 0.1
    gnss_height_noise: float = 0.1
    gnss_ang_noise_deg: float = 1.0
    lidar_pos_noise: float = 0.1
    lidar_height_noise: float = 0.1
    lidar_ang_noise_deg: float = 1.0
    update_bias_gyro: bool = True
    update_bias_acce: bool = True
    # wheel odometry (eskf.hpp:28-29 keeps var/span; the wheel geometry
    # below restores the parameters the reference trimmed away when it
    # commented out ObserveWheelSpeed, eskf.hpp:100)
    odom_var: float = 0.5
    odom_span: float = 0.1          # odometer measurement interval [s]
    wheel_radius: float = 0.155     # [m]
    circle_pulse: float = 1024.0    # encoder pulses per wheel revolution


class EskfState(NamedTuple):
    """Nominal state + covariance. dx is implicit (reset to zero after every
    update, eskf.hpp:178-196)."""

    p: jax.Array          # (3,)
    v: jax.Array          # (3,)
    R: jax.Array          # (3, 3)
    bg: jax.Array         # (3,)
    ba: jax.Array         # (3,)
    g: jax.Array          # (3,)
    cov: jax.Array        # (18, 18)
    time: jax.Array       # () seconds


def init_state(
    bg=None, ba=None, gravity=None, cov_scale: float = 1e-4, time: float = 0.0
) -> EskfState:
    """SetInitialConditions (eskf.hpp:86-94): cov = I * 1e-4."""
    z = jnp.zeros(3, dtype=jnp.float32)
    return EskfState(
        p=z, v=z, R=jnp.eye(3, dtype=jnp.float32),
        bg=z if bg is None else jnp.asarray(bg, jnp.float32),
        ba=z if ba is None else jnp.asarray(ba, jnp.float32),
        g=jnp.array([0.0, 0.0, -9.8], jnp.float32) if gravity is None else jnp.asarray(gravity, jnp.float32),
        cov=jnp.eye(18, dtype=jnp.float32) * cov_scale,
        time=jnp.float32(time),
    )


def process_noise(opts: EskfOptions) -> jax.Array:
    """BuildNoise (eskf.hpp:153-176): note the reference uses the *variances
    directly* (the squaring is commented out, eskf.hpp:159-162) — replicated
    faithfully."""
    ev, et = opts.acce_var, opts.gyro_var
    eg, ea = opts.bias_gyro_var, opts.bias_acce_var
    diag = jnp.array([0, 0, 0, ev, ev, ev, et, et, et, eg, eg, eg, ea, ea, ea, 0, 0, 0],
                     dtype=jnp.float32)
    return jnp.diag(diag)


@functools.partial(jax.jit, static_argnames=("opts",))
def predict(s: EskfState, gyro, acce, timestamp, opts: EskfOptions) -> EskfState:
    """One IMU propagation step (ESKF::Predict, eskf.hpp:238-280).

    Skips the update (state passthrough, time still advances) when
    dt > 5*imu_dt or dt < 0, the reference's dt sanity gate (eskf.hpp:243-249).
    """
    dt = timestamp - s.time
    ok = (dt <= 5.0 * opts.imu_dt) & (dt >= 0)
    dt = jnp.where(ok, dt, 0.0)

    acc_w = s.R @ (acce - s.ba)
    new_p = s.p + s.v * dt + 0.5 * acc_w * dt * dt + 0.5 * s.g * dt * dt
    new_v = s.v + acc_w * dt + s.g * dt
    dR = lie.so3_exp((gyro - s.bg) * dt)
    new_R = s.R @ dR

    # F matrix (eskf.hpp:266-272). NOTE the reference assembles F *after*
    # overwriting R_ with new_R, so the v-theta and v-ba blocks use the
    # post-update rotation — replicated faithfully.
    eye = jnp.eye(3, dtype=jnp.float32)
    F = jnp.eye(18, dtype=jnp.float32)
    F = F.at[0:3, 3:6].set(eye * dt)
    F = F.at[3:6, 6:9].set(-new_R @ lie.hat(acce - s.ba) * dt)
    F = F.at[3:6, 12:15].set(-new_R * dt)
    F = F.at[3:6, 15:18].set(eye * dt)
    F = F.at[6:9, 6:9].set(lie.so3_exp(-(gyro - s.bg) * dt))
    F = F.at[6:9, 9:12].set(-eye * dt)

    new_cov = F @ s.cov @ F.T + process_noise(opts)

    return EskfState(
        p=jnp.where(ok, new_p, s.p),
        v=jnp.where(ok, new_v, s.v),
        R=jnp.where(ok, new_R, s.R),
        bg=s.bg, ba=s.ba, g=s.g,
        cov=jnp.where(ok, new_cov, s.cov),
        time=timestamp,
    )


@functools.partial(jax.jit, static_argnames=("opts",))
def predict_scan(s: EskfState, gyros, acces, timestamps, valid, opts: EskfOptions) -> EskfState:
    """Propagate through a padded IMU packet with `lax.scan` (the per-measure
    IMU loop in Lio::AddMeasure, lio.cpp:437-440). `valid` masks padding."""

    def step(carry, x):
        gyro, acce, ts, ok = x
        nxt = predict(carry, gyro, acce, ts, opts)
        out = jax.tree_util.tree_map(lambda a, b: jnp.where(ok, a, b), nxt, carry)
        return out, None

    out, _ = jax.lax.scan(step, s, (gyros, acces, timestamps, valid))
    return out


def _update_and_reset(s: EskfState, H, V, innov, opts: EskfOptions) -> EskfState:
    """Kalman gain + inject + reset + tangent covariance projection
    (the shared tail of every Observe*, eskf.hpp:178-203)."""
    PHt = s.cov @ H.T
    K = PHt @ jnp.linalg.inv(H @ PHt + V)                      # (18, m)
    dx = K @ innov
    cov = (jnp.eye(18, dtype=jnp.float32) - K @ H) @ s.cov

    # inject + reset (eskf.hpp:179-196)
    dtheta = dx[6:9]
    new = EskfState(
        p=s.p + dx[0:3],
        v=s.v + dx[3:6],
        # renormalized: the nominal R accumulates one R@exp per IMU sample
        # (predict) and per observation; over 1e5+ steps the float32 defect
        # would reach 1e-2 (lie.so3_renormalize docstring)
        R=lie.so3_renormalize(s.R @ lie.so3_exp(dtheta)),
        bg=s.bg + dx[9:12] * (1.0 if opts.update_bias_gyro else 0.0),
        ba=s.ba + dx[12:15] * (1.0 if opts.update_bias_acce else 0.0),
        g=s.g + dx[15:18],
        cov=cov,
        time=s.time,
    )
    # project cov (eskf.hpp:199-203)
    J = jnp.eye(18, dtype=jnp.float32)
    J = J.at[6:9, 6:9].set(jnp.eye(3) - 0.5 * lie.hat(dtheta))
    return new._replace(cov=J @ new.cov @ J.T)


@functools.partial(jax.jit, static_argnames=("opts",))
def observe_se3(s: EskfState, R_obs, t_obs, opts: EskfOptions,
                trans_noise: float = 0.1, ang_noise_rad: float = 1.0 * jnp.pi / 180.0) -> EskfState:
    """Pose observation + UpdateAndReset + covariance projection
    (ESKF::ObserveSE3, eskf.hpp:289-315, 178-203)."""
    H = jnp.zeros((6, 18), dtype=jnp.float32)
    H = H.at[0:3, 0:3].set(jnp.eye(3))
    H = H.at[3:6, 6:9].set(jnp.eye(3))
    # NOTE: the reference builds V from the noise values directly, NOT their
    # squares (eskf.hpp:299-302) — replicated.
    V = jnp.diag(jnp.array([trans_noise] * 3 + [ang_noise_rad] * 3, dtype=jnp.float32))
    innov = jnp.concatenate([t_obs - s.p, lie.so3_log(s.R.T @ R_obs)])
    return _update_and_reset(s, H, V, innov, opts)


@functools.partial(jax.jit, static_argnames=("opts",))
def observe_wheel_speed(s: EskfState, left_pulse, right_pulse,
                        opts: EskfOptions) -> EskfState:
    """Wheel-odometry velocity observation.

    The reference declared but never wrote this (`ObserveWheelSpeed`
    commented out, eskf.hpp:100) while still building its noise matrix with
    SQUARED odom_var (eskf.hpp:168-169 — unlike ObserveSE3's unsquared
    noise). Implemented to the intended semantics: per-wheel speed from
    pulses over one odom_span, averaged, taken as the body-x velocity,
    rotated to world, observed on the v block (H[0:3, 3:6] = I)."""
    wheel = opts.wheel_radius * 2.0 * jnp.pi / opts.circle_pulse / opts.odom_span
    velo_l = wheel * left_pulse
    velo_r = wheel * right_pulse
    v_body = jnp.array([1.0, 0.0, 0.0], jnp.float32) * (0.5 * (velo_l + velo_r))
    v_world = s.R @ v_body

    H = jnp.zeros((3, 18), dtype=jnp.float32)
    H = H.at[0:3, 3:6].set(jnp.eye(3))
    o2 = opts.odom_var * opts.odom_var
    V = jnp.eye(3, dtype=jnp.float32) * o2
    innov = v_world - s.v
    return _update_and_reset(s, H, V, innov, opts)


def nominal_se3(s: EskfState):
    """GetNominalSE3 (eskf.hpp:143)."""
    return s.R, s.p


def set_pose(s: EskfState, R, t, gravity=None, v=None) -> EskfState:
    """SetX(SE3, grav) (eskf.hpp:135-140); `v` also seeds the world-frame
    velocity (e.g. from a GNSS or wheel-odometry fix)."""
    out = s._replace(R=jnp.asarray(R, jnp.float32), p=jnp.asarray(t, jnp.float32))
    if gravity is not None:
        out = out._replace(g=jnp.asarray(gravity, jnp.float32))
    if v is not None:
        out = out._replace(v=jnp.asarray(v, jnp.float32))
    return out


# ---------------------------------------------------------------------------
# Static IMU initializer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ImuInitOptions:
    """Mirror of ImuInitOptions (static_imu_init.h:11-30)."""

    init_time_seconds: float = 1.0
    init_imu_queue_max_size: int = 400
    static_odom_pulse: int = 5
    max_static_gyro_var: float = 0.5
    max_static_acce_var: float = 0.05
    gravity_norm: float = 9.81


class ImuInitResult(NamedTuple):
    success: jax.Array     # bool
    bg: jax.Array          # (3,) gyro bias
    ba: jax.Array          # (3,) acce bias (gravity-compensated residual)
    gravity: jax.Array     # (3,)
    cov_gyro: jax.Array    # (3,) diagonal variance
    cov_acce: jax.Array    # (3,)


def odom_is_static(left_pulse, right_pulse,
                   opts: ImuInitOptions = ImuInitOptions()):
    """Wheel-odometry stillness test (StaticIMUInit::AddOdom,
    static_imu_init.cpp:46-61): both wheels under the pulse-noise floor."""
    return (left_pulse < opts.static_odom_pulse) & \
        (right_pulse < opts.static_odom_pulse)


@functools.partial(jax.jit, static_argnames=("opts",))
def static_imu_init(gyros, acces, valid, opts: ImuInitOptions = ImuInitOptions(),
                    is_static=None) -> ImuInitResult:
    """StaticIMUInit::TryInit (static_imu_init.cpp:63-104) as one reduction
    over a padded buffer of stationary IMU samples.

    gyros/acces: (N, 3); valid: (N,) mask. The caller is responsible for the
    buffering/time-window logic (AddIMU) — here lives only the math.

    is_static: optional (N,) bool, the per-sample wheel-odometry stillness
    flag (`odom_is_static` sampled at each IMU stamp). The reference CLEARS
    its whole init queue whenever the vehicle moves (static_imu_init.cpp:
    13-18), so only the trailing contiguous static run contributes — that
    suffix semantics is replicated with a reversed cumulative AND.
    """
    from ..utils import mathx

    if is_static is not None:
        trailing = jnp.cumprod(is_static[::-1].astype(jnp.int32))[::-1]
        valid = valid & trailing.astype(bool)

    mean_gyro, cov_gyro, n = mathx.masked_mean_and_cov_diag(gyros, valid)
    mean_acce, cov_acce, _ = mathx.masked_mean_and_cov_diag(acces, valid)
    # gravity = -mean_acce scaled to 9.81 (cpp:76-78)
    gravity = -mean_acce / jnp.linalg.norm(mean_acce) * opts.gravity_norm
    # recompute acce stats about the gravity-compensated signal (cpp:80-82)
    mean_acce2, cov_acce2, _ = mathx.masked_mean_and_cov_diag(acces + gravity, valid)
    ok = (
        (n >= 10)
        & (jnp.linalg.norm(cov_gyro) <= opts.max_static_gyro_var)
        & (jnp.linalg.norm(cov_acce2) <= opts.max_static_acce_var)
    )
    return ImuInitResult(
        success=ok, bg=mean_gyro, ba=mean_acce2, gravity=gravity,
        cov_gyro=cov_gyro, cov_acce=cov_acce2,
    )


def eskf_options_from_init(init: ImuInitResult, base: EskfOptions = EskfOptions()) -> EskfOptions:
    """Seed ESKF noise from the initializer like Lio::InitImu (lio.cpp:86-93):
    gyro_var = sqrt(cov_gyro[0]), acce_var = sqrt(cov_acce[0])."""
    import numpy as np

    return dataclasses.replace(
        base,
        gyro_var=float(np.sqrt(np.asarray(init.cov_gyro)[0])),
        acce_var=float(np.sqrt(np.asarray(init.cov_acce)[0])),
    )


# ---------------------------------------------------------------------------
# Plain IMU dead-reckoning (imu_integration.cpp:11-23)
# ---------------------------------------------------------------------------

class ImuIntegState(NamedTuple):
    p: jax.Array
    v: jax.Array
    R: jax.Array
    time: jax.Array


@jax.jit
def imu_integrate(s: ImuIntegState, gyro, acce, timestamp, bg, ba, gravity) -> ImuIntegState:
    dt = jnp.maximum(timestamp - s.time, 0.0)
    acc_w = s.R @ (acce - ba) + gravity
    return ImuIntegState(
        p=s.p + s.v * dt + 0.5 * acc_w * dt * dt,
        v=s.v + acc_w * dt,
        R=s.R @ lie.so3_exp((gyro - bg) * dt),
        time=timestamp,
    )
