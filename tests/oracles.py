"""Tiny float64 numpy reimplementations of the reference math, used as
golden oracles (SURVEY.md section 4: "a small pinned reimplementation of the
reference math"). These follow the C++ semantics exactly — including division
conventions — so kernel tests pin numerical parity."""

import numpy as np


def hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=np.float64)


def so3_exp(w):
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3) + hat(w)
    a = w / theta
    W = hat(a)
    return np.eye(3) + np.sin(theta) * W + (1 - np.cos(theta)) * (W @ W)


def so3_log(R):
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos_t)
    if theta < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return theta / (2 * np.sin(theta)) * w


def fit_plane(pts, eps=1e-2):
    """math::FitPlane (math_utils.h:113-136): smallest right singular vector
    of [x y z 1]; valid iff per-point residual^2 <= eps."""
    pts = np.asarray(pts, dtype=np.float64)
    if len(pts) < 3:
        return None, False
    A = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    _, _, vt = np.linalg.svd(A)
    coeffs = vt[-1]
    resid = A @ coeffs
    return coeffs, bool(np.all(resid**2 <= eps))


def fit_plane_centered(pts, eps=1e-2):
    """The engine's plane fit in float64: centroid + PCA normal, 4-vector
    renormalized. This IS the exact [p-c, 1] TLS (the centered Gram matrix is
    block diagonal); it deviates from the reference's uncentered [p, 1] TLS
    (fit_plane above) by an origin-distance-dependent bias the rebuild
    deliberately removes (documented in loc_lib_tpu/utils/mathx.py)."""
    pts = np.asarray(pts, dtype=np.float64)
    if len(pts) < 3:
        return None, False
    c = pts.mean(axis=0)
    d = pts - c
    _, _, vt = np.linalg.svd(d)
    n = vt[-1]
    coeffs = np.concatenate([n, [-n @ c]])
    coeffs = coeffs / np.linalg.norm(coeffs)
    resid = pts @ coeffs[:3] + coeffs[3]
    return coeffs, bool(np.all(resid**2 <= eps))


def fit_line(pts, eps=0.2):
    """math::FitLine (math_utils.h:138-163)."""
    pts = np.asarray(pts, dtype=np.float64)
    if len(pts) < 2:
        return None, None, False
    origin = pts.mean(axis=0)
    Y = pts - origin
    _, _, vt = np.linalg.svd(Y)
    d = vt[0]
    ok = all(np.linalg.norm(np.cross(d, p - origin)) ** 2 <= eps for p in pts)
    return origin, d, bool(ok)


def mean_and_cov(pts):
    """math::ComputeMeanAndCov (math_utils.h:55-72): /(n-1)."""
    pts = np.asarray(pts, dtype=np.float64)
    mean = pts.mean(axis=0)
    d = pts - mean
    cov = d.T @ d / (len(pts) - 1)
    return mean, cov


def merge_gaussian(hist_n, hist_mean, hist_cov, cur_n, cur_mean, cur_cov):
    """math::UpdateMeanAndCov (math_utils.h:88-98)."""
    total = hist_n + cur_n
    new_mean = (hist_n * hist_mean + cur_n * cur_mean) / total
    dh = (hist_mean - new_mean).reshape(3, 1)
    dc = (cur_mean - new_mean).reshape(3, 1)
    new_cov = (hist_n * (hist_cov + dh @ dh.T) + cur_n * (cur_cov + dc @ dc.T)) / total
    return new_mean, new_cov


def ndt_clamped_info(cov):
    """ndt_registration.cpp:116-131: SVD, clamp lambda to lambda0*1e-3, invert."""
    u, s, vt = np.linalg.svd(cov)
    s = np.maximum(s, s[0] * 1e-3)
    return vt.T @ np.diag(1.0 / s) @ u.T


def icp_p2plane_h_b(src, tgt_pts_fn, R, t, max_plane_distance=0.1):
    """One linearization of P2Plane ICP (icp_registration.cpp:161-213).
    tgt_pts_fn(qs) must return the (k,3) neighbor set for a query."""
    H = np.zeros((6, 6))
    B = np.zeros(6)
    eff = 0
    for q in src:
        qs = R @ q + t
        nn = tgt_pts_fn(qs)
        if nn is None or len(nn) <= 3:
            continue
        coeffs, ok = fit_plane_centered(nn)
        if not ok:
            continue
        eff += 1
        dis = coeffs[:3] @ qs + coeffs[3]
        if abs(dis) > max_plane_distance:
            continue
        J = np.zeros(6)
        J[:3] = -coeffs[:3] @ (R @ hat(q))
        J[3:] = coeffs[:3]
        H += np.outer(J, J)
        B += -J * dis
    return H, B, eff


def eskf_predict(state, cov, imu_gyro, imu_acce, dt, Q):
    """ESKF::Predict (eskf.hpp:238-280). state = dict(p,v,R,bg,ba,g)."""
    p, v, R, bg, ba, g = (state[k] for k in ("p", "v", "R", "bg", "ba", "g"))
    acc = R @ (imu_acce - ba)
    new_p = p + v * dt + 0.5 * acc * dt * dt + 0.5 * g * dt * dt
    new_v = v + acc * dt + g * dt
    new_R = R @ so3_exp((imu_gyro - bg) * dt)
    F = np.eye(18)
    F[0:3, 3:6] = np.eye(3) * dt
    F[3:6, 6:9] = -new_R @ hat(imu_acce - ba) * dt
    F[3:6, 12:15] = -new_R @ np.eye(3) * dt
    F[3:6, 15:18] = np.eye(3) * dt
    F[6:9, 6:9] = so3_exp(-(imu_gyro - bg) * dt)
    F[6:9, 9:12] = -np.eye(3) * dt
    new_cov = F @ cov @ F.T + Q
    return dict(p=new_p, v=new_v, R=new_R, bg=bg, ba=ba, g=g), new_cov


def eskf_observe_se3(state, cov, obs_R, obs_t, trans_noise=0.1, ang_noise=np.deg2rad(1.0)):
    """ESKF::ObserveSE3 + UpdateAndReset (eskf.hpp:178-203, 289-315)."""
    H = np.zeros((6, 18))
    H[0:3, 0:3] = np.eye(3)
    H[3:6, 6:9] = np.eye(3)
    V = np.diag([trans_noise] * 3 + [ang_noise] * 3)
    K = cov @ H.T @ np.linalg.inv(H @ cov @ H.T + V)
    innov = np.zeros(6)
    innov[:3] = obs_t - state["p"]
    innov[3:] = so3_log(state["R"].T @ obs_R)
    dx = K @ innov
    cov = (np.eye(18) - K @ H) @ cov
    out = dict(state)
    out["p"] = state["p"] + dx[0:3]
    out["v"] = state["v"] + dx[3:6]
    out["R"] = state["R"] @ so3_exp(dx[6:9])
    out["bg"] = state["bg"] + dx[9:12]
    out["ba"] = state["ba"] + dx[12:15]
    out["g"] = state["g"] + dx[15:18]
    J = np.eye(18)
    J[6:9, 6:9] = np.eye(3) - 0.5 * hat(dx[6:9])
    cov = J @ cov @ J.T
    return out, cov, dx
