"""Gauss-Newton linearizations of the voxel scan matchers.

This module is the one place that decides how a matcher's normal equations
are formed. Every function returns `(H (6,6), b (6,), n () int32, chi2 ())`
and is written in plain `jnp`, so the same code runs on the CPU test mesh
and on the GPU, where XLA fuses the per-point producer into the reduction.

Each residual row contributes

    a = w * [ J (6) | e | flag ]        (8,)

and one contraction G = sum a a^T (8, 8) yields H = G[:6,:6],
b = -G[:6,6], chi2 = G[6,6] and the residual count n = G[7,7] (`flag` is 1
on the row that counts a residual, 0 on the others). This is the
reference's per-point accumulation loop (icp_registration.cpp:161-213,
ndt_registration.cpp:330-347, 425-433) as one batched pass.

The contraction is an elementwise multiply-reduce, which XLA fuses with
the row producer into one reduction; as a dot (`einsum`) it ran slower on
the H100 and would need `precision=HIGHEST` to stay out of TF32, whose
~2^-11 relative error at ~70 m range is centimetres, the size of the
0.1 m plane gate.
"""

from __future__ import annotations

import jax.numpy as jnp


def _rotate(R, x):
    """R x for a batch of 3-vectors x (..., 3), as elementwise products."""
    return jnp.sum(R * x[..., None, :], axis=-1)


def _rotate_t(R, x):
    """R^T x for a batch of 3-vectors x (..., 3)."""
    return jnp.sum(R * x[..., :, None], axis=-2)


def _normal_equations(a):
    """(H, b, n, chi2) from residual rows a (..., 8) via G = sum a a^T."""
    a = a.reshape(-1, 8)
    G = jnp.sum(a[:, :, None] * a[:, None, :], axis=0)
    return G[:6, :6], -G[:6, 6], G[7, 7].astype(jnp.int32), G[6, 6]


def p2plane(q, plane, w, R, t, gate):
    """Point-to-plane linearization with one plane per point.

    q (N, 3) body points, plane (N, 4) [n, d], w (N,) 0/1 validity, R (3, 3),
    t (3,), gate: a point accumulates only where |n.(R q + t) + d| <= gate
    (icp_registration.cpp:187-190). J = [-(R^T n) x q | n]
    (icp_registration.cpp:193-195)."""
    q = q.astype(jnp.float32)
    qs = _rotate(R, q) + t
    n = plane[:, 0:3]
    dis = jnp.sum(n * qs, axis=-1) + plane[:, 3]
    w = w * (jnp.abs(dis) <= gate).astype(jnp.float32)
    jrot = -jnp.cross(_rotate_t(R, n), q)
    a = jnp.concatenate(
        [jrot, n, dis[:, None], jnp.ones_like(dis)[:, None]], axis=-1)
    return _normal_equations(a * w[:, None])


def elect_nearest(rows, mu, valid, qs):
    """Nearest-valid-centroid election over S candidate voxel rows.

    rows (N, S, K), mu (N, S, 3) the candidates' centroids, valid (N, S)
    bool, qs (N, 3) world points. Returns (row (N, K), d2 (N,)): the row
    whose centroid is nearest qs among the valid ones (the first on a tie)
    and its squared distance; zero rows and d2 = inf where none is
    valid."""
    d2 = jnp.sum((mu - qs[:, None, :]) ** 2, axis=-1)
    d2 = jnp.where(valid, d2, jnp.inf)
    pick = jnp.argmin(d2, axis=1)
    row = jnp.take_along_axis(rows, pick[:, None, None], axis=1)[:, 0]
    d2 = jnp.min(d2, axis=1)
    return jnp.where(jnp.isfinite(d2)[:, None], row, 0.0), d2


def p2plane_pick(q, rows, w, R, t, gate):
    """Point-to-plane linearization that first elects each point's plane
    among S candidate rows (see `elect_nearest`); arguments as `p2plane`
    with rows (N, S, 8) [n(3), d, mu(3), valid] in place of plane."""
    q = q.astype(jnp.float32)
    plane, d2 = elect_nearest(rows[..., 0:4], rows[..., 4:7],
                              rows[..., 7] > 0.5, _rotate(R, q) + t)
    return p2plane(q, plane, w * jnp.isfinite(d2), R, t, gate)


def ndt(q, qs, mu, W, valid, R, outlier_th, weighted: bool):
    """Generalized-Gaussian linearization over a stencil of S voxels.

    q (N, 3) body points, qs (N, 3) world points, mu (N, S, 3) voxel means,
    W (N, S, 9) row-major square-root factors of the voxel information
    (info = W W^T), valid (N, S) 0/1, R (3, 3), outlier_th: a residual
    accumulates only where e^T info e <= outlier_th. With e = qs - mu and
    J = [-R hat(q) | I] (ndt_registration.cpp:330-332), each (point, voxel)
    pair gives three rows:

        weighted   a = w * [ W^T J | W^T e | flag ]   (info-weighted, AlignIncNdt)
        direct     a = w * [     J |     e | flag ]   (unweighted, AlignNdt)

    P2Line is the weighted form with S = 1 and W the perpendicular pair of
    the line direction (info = I - d d^T)."""
    q = q.astype(jnp.float32)
    n, s = valid.shape
    Wm = W.reshape(n, s, 3, 3)                           # Wm[..., k, j]
    e = qs[:, None, :] - mu                              # (N, S, 3)
    z = jnp.sum(Wm * e[..., :, None], axis=-2)           # W^T e
    res = jnp.sum(z * z, axis=-1)
    w = valid * (res <= outlier_th).astype(jnp.float32)  # (N, S)
    if weighted:
        M = jnp.sum(Wm[..., :, :, None] * R[:, None, :], axis=-3)  # W^T R
        Bt = jnp.swapaxes(Wm, -1, -2)                    # W^T
        r = z
    else:
        M = jnp.broadcast_to(R, (n, s, 3, 3))
        Bt = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, s, 3, 3))
        r = e
    # row i of -M hat(q) is q x M[i]
    jrot = jnp.cross(q[:, None, None, :], M)             # (N, S, 3, 3)
    flag = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
                            (n, s, 3))
    a = jnp.concatenate([jrot, Bt, r[..., None], flag[..., None]], axis=-1)
    return _normal_equations(a * w[:, :, None, None])
