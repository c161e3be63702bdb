"""Ring-structured correspondence search (range-image NN).

The reference prototyped exactly this as its "FPGA" experiment: replace the
kd-tree with a fixed +-2-ring x +-5-point window search over ring-organized
scans (/root/reference/slam_demo/src/apps/fpga_node.cpp:47-82 FindNearstP,
129-240 TestRingSearch) — a hardware-friendly, regular-memory NN. That is
precisely the right shape for an accelerator: organizing a scan as a
(rings, cols) range image makes the window search a pure elementwise
stencil — shifted subtracts
and running mins over a (R, C, 3) tensor, zero gathers, zero sorts — while
the hash-grid kNN (ops/voxel.py) still serves unorganized map clouds.

`scan_match_rings` closes the loop the prototype left commented out
(fpga_node.cpp:200-230): frame-to-frame P2P Gauss-Newton odometry over the
stencil correspondences.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import lie, mathx
from .pointcloud import PAD_COORD


@dataclasses.dataclass(frozen=True)
class RingOptions:
    num_rings: int = 16        # Robosense/Velodyne-16 (fpga_node.cpp:45)
    ring_len: int = 1024       # azimuth columns (10 Hz x ~0.2 deg)
    ring_window: int = 2       # +- rings searched (FindNearstP: -2..1)
    col_window: int = 5        # +- columns searched (FindNearstP: -5..4)
    max_distance: float = 1.0  # correspondence gate (fpga_node.cpp:190)
    max_iteration: int = 20
    eps: float = 1e-2
    min_effective_pts: int = 10


class RingImage(NamedTuple):
    """Ring-organized scan: xyz (R, C, 3), valid (R, C)."""

    xyz: jax.Array
    valid: jax.Array


@functools.partial(jax.jit, static_argnames=("num_rings", "ring_len"))
def organize_rings(xyz: jax.Array, ring: jax.Array, mask: jax.Array,
                   num_rings: int = 16, ring_len: int = 1024) -> RingImage:
    """Scatter an unorganized scan into a (rings, cols) range image.

    Column = azimuth bin (atan2 over [0, 2pi)); on collisions the nearest
    (smallest range) point wins, mirroring how lidar drivers keep the
    strongest return per cell.
    """
    az = jnp.arctan2(xyz[:, 1], xyz[:, 0])          # (-pi, pi]
    col = jnp.floor((az + jnp.pi) / (2 * jnp.pi) * ring_len).astype(jnp.int32)
    col = jnp.clip(col, 0, ring_len - 1)
    r = jnp.clip(ring.astype(jnp.int32), 0, num_rings - 1)
    ok = mask & (ring >= 0) & (ring < num_rings)
    flat = jnp.where(ok, r * ring_len + col, num_rings * ring_len)

    rng2 = jnp.sum(xyz * xyz, axis=-1)
    # nearest-return-wins: scatter-min the range, then scatter coords of the
    # winner (two passes keeps it deterministic)
    best = jnp.full((num_rings * ring_len + 1,), jnp.inf, jnp.float32)
    best = best.at[flat].min(jnp.where(ok, rng2, jnp.inf))
    is_winner = ok & (rng2 <= best[flat])
    img = jnp.full((num_rings * ring_len + 1, 3), PAD_COORD, xyz.dtype)
    img = img.at[jnp.where(is_winner, flat, num_rings * ring_len)].set(xyz, mode="drop")
    img = img[:-1].reshape(num_rings, ring_len, 3)
    valid = jnp.isfinite(best[:-1]).reshape(num_rings, ring_len)
    return RingImage(xyz=img, valid=valid)


@functools.partial(jax.jit, static_argnames=("ring_window", "col_window"))
def ring_window_nn(prev: RingImage, cur: RingImage,
                   ring_window: int = 2, col_window: int = 5):
    """Per-cell nearest neighbor of `cur` in `prev` within the
    +-ring_window x +-col_window stencil (FindNearstP, fpga_node.cpp:47-82).

    Pure stencil: for each (dr, dc) offset, shift `prev` and take a running
    elementwise min of the squared distance. Columns wrap (azimuth is
    periodic); rings clamp. Returns (nn_xyz (R, C, 3), d2 (R, C),
    found (R, C))."""
    R, C, _ = prev.xyz.shape
    big = jnp.float32(jnp.inf)
    best_d2 = jnp.full((R, C), big)
    best_xyz = jnp.full((R, C, 3), PAD_COORD, prev.xyz.dtype)
    for dr in range(-ring_window, ring_window + 1):
        # ring shift with clamping: out-of-range rows are invalid
        if dr >= 0:
            shifted = jnp.pad(prev.xyz[dr:], ((0, dr), (0, 0), (0, 0)),
                              constant_values=PAD_COORD)
            svalid = jnp.pad(prev.valid[dr:], ((0, dr), (0, 0)))
        else:
            shifted = jnp.pad(prev.xyz[:dr], ((-dr, 0), (0, 0), (0, 0)),
                              constant_values=PAD_COORD)
            svalid = jnp.pad(prev.valid[:dr], ((-dr, 0), (0, 0)))
        for dc in range(-col_window, col_window + 1):
            cand = jnp.roll(shifted, -dc, axis=1)
            cvalid = jnp.roll(svalid, -dc, axis=1)
            d2 = jnp.sum((cand - cur.xyz) ** 2, axis=-1)
            d2 = jnp.where(cvalid & cur.valid, d2, big)
            take = d2 < best_d2
            best_d2 = jnp.where(take, d2, best_d2)
            best_xyz = jnp.where(take[..., None], cand, best_xyz)
    return best_xyz, best_d2, jnp.isfinite(best_d2)


class RingMatchResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    converged: jax.Array
    num_effective: jax.Array
    iterations: jax.Array
    chi2: jax.Array


@functools.partial(jax.jit, static_argnames=("opts",))
def scan_match_rings(prev: RingImage, cur: RingImage, opts: RingOptions,
                     R0=None, t0=None) -> RingMatchResult:
    """Frame-to-frame P2P GN over ring-window correspondences — the solve
    the FPGA prototype sketched (fpga_node.cpp:200-230: J = [R hat(q), -I],
    H += J^T J, B += -J^T e, dx = H^-1 B, right-retract)."""
    q = cur.xyz.reshape(-1, 3)
    qvalid = cur.valid.reshape(-1)
    R0 = jnp.eye(3, dtype=jnp.float32) if R0 is None else R0
    t0 = jnp.zeros(3, jnp.float32) if t0 is None else t0

    def body(state):
        it, R, t, _, _, _ = state
        qs = q @ R.T + t
        moved = RingImage(xyz=qs.reshape(cur.xyz.shape), valid=cur.valid)
        nn, d2, found = ring_window_nn(prev, moved, opts.ring_window,
                                       opts.col_window)
        nn = nn.reshape(-1, 3)
        d2 = d2.reshape(-1)
        eff = found.reshape(-1) & qvalid & (d2 <= opts.max_distance ** 2)
        e = nn - qs
        Rhatq = jnp.einsum("ij,njk->nik", R, lie.hat(q))
        J = jnp.concatenate(
            [Rhatq, jnp.broadcast_to(-jnp.eye(3, dtype=q.dtype), Rhatq.shape)],
            axis=-1)
        w = eff.astype(q.dtype)
        Jw = (J * w[:, None, None]).reshape(-1, 6)
        H = Jw.T @ Jw
        b = -(Jw.T @ (e * w[:, None]).reshape(-1))
        n_eff = jnp.sum(eff)
        ok = n_eff >= opts.min_effective_pts
        dx = jnp.where(ok, mathx.solve_gn_6x6(H, b), jnp.zeros(6, b.dtype))
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        R_new, t_new = lie.se3_retract(R, t, dx)
        chi2 = jnp.sum(jnp.sum(e * e, axis=-1) * w)
        return (it + 1, R_new, t_new, ok & (jnp.linalg.norm(dx) < opts.eps),
                n_eff, chi2)

    def cond(state):
        it, _, _, done, _, _ = state
        return (it < opts.max_iteration) & (~done)

    init = (jnp.int32(0), jnp.asarray(R0, jnp.float32),
            jnp.asarray(t0, jnp.float32), jnp.bool_(False), jnp.int32(0),
            jnp.float32(0.0))
    it, R, t, converged, n_eff, chi2 = jax.lax.while_loop(cond, body, init)
    return RingMatchResult(R=lie.so3_renormalize(R), t=t, converged=converged,
                           num_effective=n_eff, iterations=it, chi2=chi2)
