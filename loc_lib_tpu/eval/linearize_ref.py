"""Float64 NumPy references for `ops.linearize`, and inputs to check it on.

Each reference evaluates the same formula as its `ops.linearize`
counterpart, written per residual row in float64 from the float32 inputs.
`make_case` draws seeded inputs at a given width whose gate and election
decisions sit clear of their thresholds, so float32 and float64 agree on
every decision and the residual counts must match exactly.

`TOLERANCE` states how close the float32 linearization must come: relative
Frobenius error of H and of b, and relative error of chi2. The bounds
allow for float32 rounding of the residuals and float32 accumulation over
~10^4-10^5 rows in another order. The same contraction taken as a TF32 dot
fails the b bound for every kind (1.5e-4 to 5.4e-4 at N=8192 on an H100),
whose terms cancel, while H and chi2 stay inside theirs.
"""

from __future__ import annotations

import numpy as np

TOLERANCE = {"H": 1e-4, "b": 1e-4, "chi2": 1e-3}
KINDS = ("p2plane", "p2plane_pick", "ndt_weighted", "ndt_direct", "p2line")
STENCIL = 7          # NEARBY6 + self
PLANE_GATE = 0.1     # IcpOptions.max_plane_distance
NDT_TH = 20.0        # NdtOptions.res_outlier_th
LINE_TH = 0.5 ** 2   # IcpOptions.max_line_distance, squared
_MARGIN = 1e-3       # relative clearance of every gate / election decision
_EXTENT = 10.0       # points within +-_EXTENT m of the sensor


def _so3_exp(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K


def _gram(a):
    a = np.asarray(a, np.float64).reshape(-1, 8)
    G = a.T @ a
    return G[:6, :6], -G[:6, 6], int(round(G[7, 7])), G[6, 6]


def p2plane_ref(q, plane, w, R, t, gate):
    q, plane, R, t = (np.asarray(x, np.float64) for x in (q, plane, R, t))
    qs = q @ R.T + t
    n = plane[:, :3]
    dis = np.sum(n * qs, axis=1) + plane[:, 3]
    wf = np.asarray(w, np.float64) * (np.abs(dis) <= gate)
    jrot = -np.cross(n @ R, q)                      # -(R^T n) x q
    a = np.concatenate([jrot, n, dis[:, None], np.ones_like(dis)[:, None]], 1)
    return _gram(a * wf[:, None])


def elect_plane_ref(rows, qs):
    rows = np.asarray(rows, np.float64)
    valid = rows[..., 7] > 0.5
    d2 = np.sum((rows[..., 4:7] - np.asarray(qs, np.float64)[:, None]) ** 2, -1)
    d2 = np.where(valid, d2, np.inf)
    pick = np.argmin(d2, axis=1)
    plane = rows[np.arange(len(rows)), pick, :4]
    has = valid.any(axis=1)
    return np.where(has[:, None], plane, 0.0), has.astype(np.float64)


def p2plane_pick_ref(q, rows, w, R, t, gate):
    qs = np.asarray(q, np.float64) @ np.asarray(R, np.float64).T + t
    plane, has = elect_plane_ref(rows, qs)
    return p2plane_ref(q, plane, np.asarray(w, np.float64) * has, R, t, gate)


def ndt_ref(q, qs, mu, W, valid, R, outlier_th, weighted):
    q, qs, mu, W, R = (np.asarray(x, np.float64) for x in (q, qs, mu, W, R))
    n, s = np.shape(valid)
    Wm = W.reshape(n, s, 3, 3)
    e = qs[:, None, :] - mu
    z = np.einsum("nskj,nsk->nsj", Wm, e)           # W^T e
    res = np.sum(z * z, -1)
    wf = np.asarray(valid, np.float64) * (res <= outlier_th)
    # J = [-R hat(q) | I] per point, shared over the stencil
    hq = np.zeros((n, 3, 3))
    hq[:, 0, 1], hq[:, 0, 2] = -q[:, 2], q[:, 1]
    hq[:, 1, 0], hq[:, 1, 2] = q[:, 2], -q[:, 0]
    hq[:, 2, 0], hq[:, 2, 1] = -q[:, 1], q[:, 0]
    J = np.concatenate([-np.einsum("ij,njk->nik", R, hq),
                        np.broadcast_to(np.eye(3), (n, 3, 3))], -1)
    if weighted:
        JJ = np.einsum("nskj,nkc->nsjc", Wm, J)     # W^T J
        r = z
    else:
        JJ = np.broadcast_to(J[:, None], (n, s, 3, 6))
        r = e
    flag = np.broadcast_to(np.array([1.0, 0.0, 0.0]), (n, s, 3))
    a = np.concatenate([JJ, r[..., None], flag[..., None]], -1)
    return _gram(a * wf[:, :, None, None])


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def make_case(kind: str, n: int, seed: int = 0):
    """(args, kwargs) for `ops.linearize.<fn>(*args, **kwargs)` and the
    matching `*_ref`; see `case_fns`. About a tenth of the points are fully
    masked (w = 0, or no valid stencil row)."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    R = f32(_so3_exp(np.array([0.05, -0.1, 0.2])))
    t = f32([0.3, -0.1, 0.25])
    q = f32(rng.uniform(-_EXTENT, _EXTENT, (n, 3)))
    qs64 = q.astype(np.float64) @ R.astype(np.float64).T + t
    masked = rng.uniform(size=n) < 0.1

    if kind in ("p2plane", "p2plane_pick"):
        s = 1 if kind == "p2plane" else STENCIL
        nv = _unit(rng, (n, s))
        mu = qs64[:, None] + rng.normal(0, 0.5, (n, s, 3))
        # signed plane distance of qs spread over +-1.5 gate
        dis = rng.uniform(-1.5, 1.5, (n, s)) * PLANE_GATE
        d = dis - np.sum(nv * qs64[:, None], -1)
        valid = rng.uniform(size=(n, s)) < 0.7
        valid[masked] = False
        if s > 1:
            d2 = np.sum((mu - qs64[:, None]) ** 2, -1)
            d2v = np.sort(np.where(valid, d2, np.inf), axis=1)
            with np.errstate(invalid="ignore"):
                gap = d2v[:, 1] - d2v[:, 0]
            tie = np.isfinite(d2v[:, 1]) & (gap < _MARGIN * (1 + d2v[:, 0]))
            keep = np.argmin(np.where(valid, d2, np.inf), axis=1)
            valid[tie] = False
            valid[tie, keep[tie]] = True
        # keep every |dis| clear of the gate
        near = np.abs(np.abs(dis) - PLANE_GATE) < _MARGIN * 10
        d = np.where(near, d - dis + 0.5 * PLANE_GATE * np.sign(dis), d)
        rows = f32(np.concatenate([nv, d[..., None], mu, valid[..., None]], -1))
        gate = np.float32(PLANE_GATE)
        if kind == "p2plane":
            w = f32(rows[:, 0, 7])
            return (q, rows[:, 0, :4], w, R, t, gate), {}
        return (q, rows, f32(~masked), R, t, gate), {}

    s = 1 if kind == "p2line" else STENCIL
    mu = qs64[:, None] + rng.normal(0, 1.0 if s > 1 else 0.4, (n, s, 3))
    if kind == "p2line":
        # W = [v0 v1 0]: the perpendicular pair of a line direction
        dvec = _unit(rng, (n, s))
        v0 = _unit(rng, (n, s))
        v0 -= np.sum(v0 * dvec, -1, keepdims=True) * dvec
        v0 /= np.linalg.norm(v0, axis=-1, keepdims=True)
        v1 = np.cross(dvec, v0)
        Wm = np.stack([v0, v1, np.zeros_like(v0)], -1)       # (n, s, 3, 3)
        th = LINE_TH
    else:
        # Cholesky-like factor of a random SPD information matrix
        A = rng.normal(0, 1.0, (n, s, 3, 3))
        Wm = np.linalg.cholesky(A @ np.swapaxes(A, -1, -2)
                                + 0.5 * np.eye(3))
        th = NDT_TH
    z = np.einsum("nskj,nsk->nsj", Wm, qs64[:, None] - mu)
    res = np.sum(z * z, -1)
    valid = (rng.uniform(size=(n, s)) < 0.8) & ~masked[:, None]
    valid &= np.abs(res - th) > _MARGIN * 10 * th
    W = f32(Wm.reshape(n, s, 9))
    return ((q, f32(qs64), f32(mu), W, f32(valid), R, np.float32(th)),
            {"weighted": kind != "ndt_direct"})


def case_fns(kind: str):
    """(name of the `ops.linearize` function, float64 reference) for a kind."""
    return {"p2plane": ("p2plane", p2plane_ref),
            "p2plane_pick": ("p2plane_pick", p2plane_pick_ref),
            "ndt_weighted": ("ndt", ndt_ref),
            "ndt_direct": ("ndt", ndt_ref),
            "p2line": ("ndt", ndt_ref)}[kind]


def compare(got, ref) -> dict:
    """Relative errors of (H, b, chi2) and both counts, for `TOLERANCE`."""
    H, b, n, chi2 = (np.asarray(x, np.float64) for x in got)
    Hr, br, nr, cr = ref
    rel = lambda x, y: float(np.linalg.norm(x - y) / max(np.linalg.norm(y),
                                                         1e-30))
    return {"H": rel(H, Hr), "b": rel(b, br), "chi2": rel(chi2, cr),
            "n": int(n), "n_ref": int(nr)}


def within_tolerance(err: dict) -> bool:
    return (err["n"] == err["n_ref"] and err["n_ref"] > 0
            and all(err[k] <= v for k, v in TOLERANCE.items()))
