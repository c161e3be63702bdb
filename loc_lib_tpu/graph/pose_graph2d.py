"""SE(2) pose-graph optimization — the direct rebuild of the reference's 2D
loop-closing backend (/root/reference/LocUtils/src/mapping_2d/
loop_closing.cpp:160-255, g2o types in common/g2o_types.h:20-33,112-129).

Same architecture as the SE(3) module (graph/pose_graph.py) with a 3-dim
tangent (x, y, theta): vmap-linearized edges with autodiff Jacobians,
block-sparse assembly, Huber/Cauchy reweighting, two-phase chi2 gating of
loop edges. The reference's residual is
  r = (T_i^-1 T_j) boxminus Z_ij = [R(-th_i)(t_j - t_i) - t_z ;
                                    wrap(th_j - th_i - th_z)]
(EdgeSE2::computeError semantics)."""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils import lie
from .pose_graph import PgoOptions, solve_pcg


class Pgo2dResult(NamedTuple):
    """optimize() result (see pose_graph.PgoResult: norms folded into the
    solve so two-phase costs exactly one XLA compile)."""

    theta: jax.Array
    t: jax.Array
    chi2: jax.Array
    chi2_hist: jax.Array
    rot_norm: jax.Array
    trans_norm: jax.Array


class Se2Edges(NamedTuple):
    i: jax.Array        # (E,) int32
    j: jax.Array        # (E,) int32
    theta: jax.Array    # (E,)   measured relative yaw
    t: jax.Array        # (E, 2) measured relative translation
    info: jax.Array     # (E, 3, 3)
    is_loop: jax.Array  # (E,) bool
    valid: jax.Array    # (E,) bool


def _se2_residual(thi, ti, thj, tj, thm, tm, xi_i, xi_j):
    """Right-perturbed residual; xi = (dx, dy, dtheta) applied in the body
    frame: T <- T * Exp(xi)."""
    ci, si = jnp.cos(thi + xi_i[2]), jnp.sin(thi + xi_i[2])
    cj, sj = jnp.cos(thj + xi_j[2]), jnp.sin(thj + xi_j[2])
    ti2 = ti + jnp.stack([jnp.cos(thi) * xi_i[0] - jnp.sin(thi) * xi_i[1],
                          jnp.sin(thi) * xi_i[0] + jnp.cos(thi) * xi_i[1]])
    tj2 = tj + jnp.stack([jnp.cos(thj) * xi_j[0] - jnp.sin(thj) * xi_j[1],
                          jnp.sin(thj) * xi_j[0] + jnp.cos(thj) * xi_j[1]])
    d = tj2 - ti2
    rel_t = jnp.stack([ci * d[0] + si * d[1], -si * d[0] + ci * d[1]])
    rel_th = (thj + xi_j[2]) - (thi + xi_i[2])
    r_t = rel_t - tm
    r_th = lie.wrap_angle(rel_th - thm)
    return jnp.concatenate([r_t, r_th[None]])


def _linearize_one(thi, ti, thj, tj, thm, tm):
    z = jnp.zeros(3, jnp.float32)
    r = _se2_residual(thi, ti, thj, tj, thm, tm, z, z)
    Ji = jax.jacfwd(lambda x: _se2_residual(thi, ti, thj, tj, thm, tm, x, z))(z)
    Jj = jax.jacfwd(lambda x: _se2_residual(thi, ti, thj, tj, thm, tm, z, x))(z)
    return r, Ji, Jj


_linearize = jax.vmap(_linearize_one)


def _robust_weight(opts: PgoOptions, chi2: jax.Array) -> jax.Array:
    d2 = opts.kernel_delta ** 2
    if opts.kernel == "cauchy":
        return 1.0 / (1.0 + chi2 / d2)
    if opts.kernel == "huber":
        s = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        return jnp.where(s <= opts.kernel_delta, 1.0, opts.kernel_delta / s)
    return jnp.ones_like(chi2)


def edge_chi2(theta, t, edges: Se2Edges) -> jax.Array:
    r, _, _ = _linearize(theta[edges.i], t[edges.i], theta[edges.j], t[edges.j],
                         edges.theta, edges.t)
    return jnp.einsum("ei,eij,ej->e", r, edges.info, r)


def edge_residual_norms(theta, t, edges: Se2Edges):
    """Per-edge residual split into (rot_norm [rad], trans_norm [m])."""
    r, _, _ = _linearize(theta[edges.i], t[edges.i], theta[edges.j], t[edges.j],
                         edges.theta, edges.t)
    return jnp.abs(r[:, 2]), jnp.linalg.norm(r[:, :2], axis=-1)


@functools.partial(jax.jit, static_argnames=("opts", "num_nodes"))
def optimize(theta, t, edges: Se2Edges, opts: PgoOptions = PgoOptions(),
             num_nodes: Optional[int] = None, num_iterations=None):
    """`num_iterations`: RUNTIME iteration count, clamped to
    opts.iteration_bound = max(max_iterations, second_phase_iterations);
    two-phase passes it as a traced scalar so both phases share one
    compiled program (see pose_graph.optimize)."""
    m = num_nodes or theta.shape[0]
    n_it = jnp.minimum(jnp.int32(opts.max_iterations if num_iterations is None
                                 else num_iterations),
                       opts.iteration_bound)

    def gn_iter(carry, _):
        th, tt = carry
        r, Ji, Jj = _linearize(th[edges.i], tt[edges.i], th[edges.j], tt[edges.j],
                               edges.theta, edges.t)
        chi2 = jnp.einsum("ei,eij,ej->e", r, edges.info, r)
        w = _robust_weight(opts, chi2) * edges.valid.astype(r.dtype)
        info_w = edges.info * w[:, None, None]

        Hii = jnp.einsum("eki,ekl,elj->eij", Ji, info_w, Ji)
        Hjj = jnp.einsum("eki,ekl,elj->eij", Jj, info_w, Jj)
        Hij = jnp.einsum("eki,ekl,elj->eij", Ji, info_w, Jj)
        bi = -jnp.einsum("eki,ekl,el->ei", Ji, info_w, r)
        bj = -jnp.einsum("eki,ekl,el->ei", Jj, info_w, r)

        Hd = jax.ops.segment_sum(Hii, edges.i, num_segments=m) + \
            jax.ops.segment_sum(Hjj, edges.j, num_segments=m)
        b = jax.ops.segment_sum(bi, edges.i, num_segments=m) + \
            jax.ops.segment_sum(bj, edges.j, num_segments=m)
        eye3 = jnp.eye(3, dtype=jnp.float32)
        Hd = Hd + opts.damping * eye3
        Hd = Hd.at[0].add(opts.gauge_weight * eye3)
        Hij_v = Hij * edges.valid[:, None, None]

        if opts.solver == "dense":
            H = jnp.zeros((m, 3, m, 3), jnp.float32)
            idx = jnp.arange(m)
            H = H.at[idx, :, idx, :].set(Hd)
            H = H.at[edges.i, :, edges.j, :].add(Hij_v)
            H = H.at[edges.j, :, edges.i, :].add(
                jnp.swapaxes(Hij_v, -1, -2))
            dx = jnp.linalg.solve(H.reshape(3 * m, 3 * m),
                                  b.reshape(3 * m)).reshape(m, 3)
        else:
            # the block-sparse PCG is block-size generic (pose_graph.py):
            # O(M+E) memory, same solver the SE(3) graph uses
            dx = solve_pcg(Hd, Hij_v, edges.i, edges.j, b, m,
                           opts.max_cg_iterations, opts.cg_tol)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        # apply body-frame perturbation (matching the residual's convention)
        c, s = jnp.cos(th), jnp.sin(th)
        tt2 = tt + jnp.stack([c * dx[:, 0] - s * dx[:, 1],
                              s * dx[:, 0] + c * dx[:, 1]], axis=-1)
        th2 = lie.wrap_angle(th + dx[:, 2])
        return (th2, tt2), jnp.sum(chi2 * edges.valid)

    def cond(st):
        return st[0] < n_it

    def body(st):
        k, th, tt, hist = st
        (th2, tt2), total = gn_iter((th, tt), None)
        hist = jnp.where(jnp.arange(hist.shape[0]) >= k, total, hist)
        return (k + 1, th2, tt2, hist)

    hist0 = jnp.zeros((opts.iteration_bound,), jnp.float32)
    _, th, tt, hist = jax.lax.while_loop(
        cond, body, (jnp.int32(0), theta, t, hist0))
    r, _, _ = _linearize(th[edges.i], tt[edges.i], th[edges.j], tt[edges.j],
                         edges.theta, edges.t)
    chi2 = jnp.einsum("ei,eij,ej->e", r, edges.info, r)
    return Pgo2dResult(theta=th, t=tt, chi2=chi2, chi2_hist=hist,
                       rot_norm=jnp.abs(r[:, 2]),
                       trans_norm=jnp.linalg.norm(r[:, :2], axis=-1))


def optimize_two_phase(theta, t, edges: Se2Edges,
                       opts: PgoOptions = PgoOptions()):
    """Two-phase optimize + residual-gated loop validation
    (loop_closing.cpp:219-246; the reference gates on chi2 with info = I,
    i.e. on raw residual magnitude — see PgoOptions.loop_gate_*).
    Returns (theta, t, loop_inlier_mask_over_all_edges).

    All three stages (pre-gate via num_iterations=0, phase 1, phase 2) are
    calls into ONE compiled optimize program (see pose_graph)."""
    res0 = optimize(theta, t, edges, opts, num_iterations=jnp.int32(0))
    plausible = (~edges.is_loop) | (
        (res0.trans_norm <= opts.loop_pregate_trans)
        & (res0.rot_norm <= opts.loop_pregate_rot))
    edges1 = edges._replace(valid=edges.valid & plausible)
    res1 = optimize(theta, t, edges1, opts,
                    num_iterations=jnp.int32(opts.max_iterations))
    inlier = plausible & ((~edges.is_loop)
                          | ((res1.trans_norm <= opts.loop_gate_trans)
                             & (res1.rot_norm <= opts.loop_gate_rot)))
    edges2 = edges._replace(valid=edges.valid & inlier)
    res2 = optimize(res1.theta, res1.t, edges2, opts,
                    num_iterations=jnp.int32(opts.second_phase_iterations))
    return res2.theta, res2.t, inlier & edges.is_loop


def odometry_edges(theta, t, info_scale: float = 1e4) -> Se2Edges:
    """Sequential edges with info = 1e4 * I (loop_closing.cpp:192-199)."""
    m = theta.shape[0]
    i = jnp.arange(m - 1, dtype=jnp.int32)
    j = i + 1
    c, s = jnp.cos(theta[i]), jnp.sin(theta[i])
    d = t[j] - t[i]
    rel_t = jnp.stack([c * d[:, 0] + s * d[:, 1],
                       -s * d[:, 0] + c * d[:, 1]], axis=-1)
    rel_th = lie.wrap_angle(theta[j] - theta[i])
    info = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32) * info_scale, (m - 1, 3, 3))
    return Se2Edges(i=i, j=j, theta=rel_th, t=rel_t, info=info,
                    is_loop=jnp.zeros((m - 1,), bool),
                    valid=jnp.ones((m - 1,), bool))


def concat_edges(a: Se2Edges, b: Se2Edges) -> Se2Edges:
    return Se2Edges(*[jnp.concatenate([x, y]) for x, y in zip(a, b)])


def build_graph_np(theta, t, loops, info_scale: float = 1e4,
                   loop_info_scale: float = 1e4):
    """Whole SE(2) graph build + shape-bucket padding in HOST numpy.

    The eager-jnp build (odometry_edges +
    concat_edges + pad_graph) compiles a fresh set of tiny executables for
    every new PRE-pad shape — and the pre-pad edge count changes with
    every accepted loop, so each Mapping2D.optimize call paid ~18 s of op
    compiles even though the bucketed solver itself was cached (measured,
    PROFILE §16). Host numpy costs microseconds; the jitted solver ingests
    the arrays directly.

    `loops`: iterable of (i, j, theta_ij, t_ij, valid). Returns
    (theta_pad, t_pad, Se2Edges-of-numpy, m_real).

    Shapes are COARSE geometric buckets (nodes >= 32, edges >= 64, then
    doubling): a submap graph is tens of nodes, the dense solve is trivial
    at this scale, and each distinct solver shape costs a compile — one
    executable covers almost every 2D
    session and can be warmed at engine init
    (mapping2d_device._warm_loop_programs)."""
    import numpy as np

    theta = np.asarray(theta, np.float32)
    t = np.asarray(t, np.float32)
    m = len(theta)
    i = np.arange(m - 1, dtype=np.int32)
    j = i + 1
    c, s = np.cos(theta[i]), np.sin(theta[i])
    d = t[j] - t[i]
    rel_t = np.stack([c * d[:, 0] + s * d[:, 1],
                      -s * d[:, 0] + c * d[:, 1]], axis=-1)
    rel_th = ((theta[j] - theta[i] + np.pi) % (2 * np.pi) - np.pi)
    n_loop = len(loops)
    e = (m - 1) + n_loop
    mp, ep = 32, 64
    while mp < m:
        mp *= 2
    while ep < e:
        ep *= 2
    k = ep - e

    ei = np.concatenate([i, np.array([l[0] for l in loops], np.int32),
                         np.zeros((k,), np.int32)])
    ej = np.concatenate([j, np.array([l[1] for l in loops], np.int32),
                         np.zeros((k,), np.int32)])
    eth = np.concatenate([rel_th.astype(np.float32),
                          np.array([l[2] for l in loops], np.float32),
                          np.zeros((k,), np.float32)])
    et = np.concatenate([rel_t.astype(np.float32),
                         (np.stack([l[3] for l in loops]).astype(np.float32)
                          if n_loop else np.zeros((0, 2), np.float32)),
                         np.zeros((k, 2), np.float32)])
    info = np.concatenate([
        np.broadcast_to(np.eye(3, dtype=np.float32) * info_scale,
                        (m - 1, 3, 3)),
        np.broadcast_to(np.eye(3, dtype=np.float32) * loop_info_scale,
                        (n_loop, 3, 3)),
        np.broadcast_to(np.eye(3, dtype=np.float32), (k, 3, 3))])
    is_loop = np.concatenate([np.zeros((m - 1,), bool),
                              np.ones((n_loop,), bool),
                              np.zeros((k,), bool)])
    valid = np.concatenate([np.ones((m - 1,), bool),
                            np.array([bool(l[4]) for l in loops], bool),
                            np.zeros((k,), bool)])
    theta_pad = np.concatenate([theta, np.zeros((mp - m,), np.float32)])
    t_pad = np.concatenate([t, np.zeros((mp - m, 2), np.float32)])
    edges = Se2Edges(i=ei, j=ej, theta=eth, t=np.ascontiguousarray(et),
                     info=np.ascontiguousarray(info), is_loop=is_loop,
                     valid=valid)
    return theta_pad, t_pad, edges, m


def pad_graph(theta, t, edges: Se2Edges, bucket: int = 8):
    """Pad nodes and edges up to the next multiple of `bucket` (the SE(2)
    analog of pose_graph.pad_graph): caps shape-driven recompiles of the
    solver at one per bucket step while a mapping run grows its submap
    graph. Padded nodes are identity with no incident edges; padded edges
    carry valid=False. Returns (theta_pad, t_pad, edges_pad, m_real)."""
    m, e = theta.shape[0], edges.i.shape[0]
    mp = -(-m // bucket) * bucket
    ep = -(-e // bucket) * bucket
    if mp == m and ep == e:
        return theta, t, edges, m
    theta_pad = jnp.concatenate([theta, jnp.zeros((mp - m,), jnp.float32)])
    t_pad = jnp.concatenate([t, jnp.zeros((mp - m, 2), jnp.float32)])
    k = ep - e
    pad = Se2Edges(
        i=jnp.zeros((k,), jnp.int32), j=jnp.zeros((k,), jnp.int32),
        theta=jnp.zeros((k,), jnp.float32), t=jnp.zeros((k, 2), jnp.float32),
        info=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (k, 3, 3)),
        is_loop=jnp.zeros((k,), bool), valid=jnp.zeros((k,), bool))
    return theta_pad, t_pad, concat_edges(edges, pad), m
