"""LOAM: curvature feature extraction + fused edge/surf registration.

Rebuild of the reference LOAM stack:

  * `LoamFeatureExtract` (/root/reference/LocUtils/src/model/feature_extract/
    loam_feature_extract.cpp): the per-ring sequential loops become one
    batched 1-D stencil program over a ring-sorted point array. Curvature is
    the squared norm of the 11-point second difference
    (loam_feature_extract.cpp:47-70); each ring is split into 6 index-range
    sectors (cpp:74-90); per sector at most 20 maximum-curvature points with
    curvature > 0.1 become edges, suppressing +-5 neighbors
    (cpp:100-143); the remaining unsuppressed points are surf (cpp:146-152).
    Documented deviations for fixed-shape execution: (a) edge picks are
    top-k by curvature with one-shot neighbor suppression via a local-max
    test (curvature must be the max of its +-5 ring window), instead of the
    reference's sequential pick-then-suppress loop; (b) the suppression-stop
    at depth gaps > 0.05 (cpp:124-127) is not replicated (it only lets a few
    extra points near discontinuities survive as candidates).

  * `LoamRegistration` (/root/reference/LocUtils/src/model/matching/3d/loam/
    loam_registration.cpp): two ICP linearizations per GN iteration — edge
    against a P2Line target, surf against a P2Plane target — fused as
    H = H_edge + H_surf, B = B_edge + B_surf, one joint 6-DoF solve
    (loam_registration.cpp:48-92; the reference swaps the H_edge/H_surf
    variable names at :57/:67 — harmless since they are summed).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.pointcloud import PointCloud, PAD_COORD
from ..utils import lie, mathx
from . import icp


@dataclasses.dataclass(frozen=True)
class LoamFeatureOptions:
    """Mirror of LoamFeatureOptions (loam_feature_extract.hpp:20-45)."""

    num_scan: int = 16
    min_ring_pts: int = 131        # rings shorter than this are skipped (cpp:40)
    edge_curvature_th: float = 0.1
    max_edge_per_sector: int = 20
    num_sectors: int = 6
    suppress_radius: int = 5


@dataclasses.dataclass(frozen=True)
class LoamOption:
    """Mirror of LoamOption (loam_registration.hpp:23-36).

    Defaults are the PRODUCTION fused voxel methods (surf=p2plane_vox,
    edge=p2line_vox): per-voxel geometry precomputed at set_target, fused
    Pallas linearization per GN iteration — the same amortization the
    reference applies to NDT (ndt_registration.cpp:87-148 build vs :262-372
    align), here applied to LOAM's dual targets. The reference's per-probe
    5-NN + fit behavior (surf_icp=P2PLANE, edge_icp=P2LINE,
    loam_registration.hpp:24-27) remains available as the pinned oracle
    (pass method="p2plane"/"p2line"); prefer it on very sparse feature
    clouds where voxels can't reach plane_min_pts support."""

    feature: LoamFeatureOptions = LoamFeatureOptions()
    surf_icp: icp.IcpOptions = icp.IcpOptions(method="p2plane_vox")
    edge_icp: icp.IcpOptions = icp.IcpOptions(method="p2line_vox")
    min_edge_pts: int = 20
    min_surf_pts: int = 20
    max_iteration: int = 20
    use_edge_points: bool = True
    use_surf_points: bool = True
    eps: float = 1e-3


class LoamFeatures(NamedTuple):
    edge: PointCloud
    surf: PointCloud


def _ring_position(ring_sorted: jax.Array, valid: jax.Array):
    """Index of each row within its ring and the ring's total size, for rows
    already sorted by ring. Returns (idx_in_ring, ring_size)."""
    n = ring_sorted.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), ring_sorted[1:] != ring_sorted[:-1]]
    ) & valid
    start_pos = jax.lax.cummax(jnp.where(is_start, idx, 0))
    idx_in_ring = idx - start_pos
    seg_id = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    seg_id = jnp.maximum(seg_id, 0)
    counts = jax.ops.segment_sum(valid.astype(jnp.int32), seg_id, num_segments=n)
    ring_size = counts[seg_id]
    return idx_in_ring, ring_size


@functools.partial(jax.jit, static_argnames=("opts",))
def extract_features(pc: PointCloud, opts: LoamFeatureOptions = LoamFeatureOptions()) -> LoamFeatures:
    """Edge/surf split of a ring-annotated cloud (LoamFeatureExtract::Extract).

    Requires pc.ring. Output clouds keep the input capacity with masks
    selecting the feature subsets (coordinates unchanged).
    """
    assert pc.ring is not None, "LOAM extraction needs per-point ring indices"
    n = pc.capacity
    r = opts.suppress_radius

    # Sort by ring, stable in scan order (the per-ring buckets of cpp:25-35).
    ring_key = jnp.where(pc.mask, pc.ring, jnp.int32(1 << 20))
    order = jnp.argsort(ring_key, stable=True)
    xyz = pc.xyz[order]
    ring = ring_key[order]
    valid = pc.mask[order]

    # 11-point second difference along the sorted axis (cpp:47-70).
    deltas = [s for s in range(-r, r + 1) if s != 0]
    acc = -2.0 * r * xyz
    same_ring = valid
    for s in deltas:
        sh = jnp.roll(xyz, -s, axis=0)
        acc = acc + sh
        same_ring = same_ring & (jnp.roll(ring, -s) == ring) & jnp.roll(valid, -s)
    curvature = jnp.sum(acc * acc, axis=-1)

    idx_in_ring, ring_size = _ring_position(ring, valid)
    in_window = same_ring & (idx_in_ring >= r) & (idx_in_ring < ring_size - r)
    ring_ok = ring_size >= opts.min_ring_pts
    eligible = valid & in_window & ring_ok

    # 6 index-range sectors over total = ring_size - 2r (cpp:74-90).
    total = jnp.maximum(ring_size - 2 * r, 1)
    sector = jnp.clip(
        (idx_in_ring - r) * opts.num_sectors // total, 0, opts.num_sectors - 1
    )

    # Edge = top-20 curvature per (ring, sector) among local maxima above the
    # threshold. Local-max test stands in for sequential suppression.
    win_max = curvature
    for s in deltas:
        win_max = jnp.maximum(win_max, jnp.where(jnp.roll(ring, -s) == ring,
                                                 jnp.roll(curvature, -s), -jnp.inf))
    is_local_max = curvature >= win_max
    cand = eligible & is_local_max & (curvature > opts.edge_curvature_th)

    sector_key = ring * opts.num_sectors + sector
    sector_key = jnp.where(cand, sector_key, jnp.int32(1 << 24))
    # rank candidates within sector by descending curvature
    rank_order = jnp.lexsort((-curvature, sector_key))
    rk_sector = sector_key[rank_order]
    idx2 = jnp.arange(n, dtype=jnp.int32)
    sec_start = jnp.concatenate(
        [jnp.ones((1,), bool), rk_sector[1:] != rk_sector[:-1]]
    )
    start_pos = jax.lax.cummax(jnp.where(sec_start, idx2, 0))
    rank_sorted = idx2 - start_pos
    rank = jnp.zeros((n,), jnp.int32).at[rank_order].set(rank_sorted)
    edge_mask = cand & (rank < opts.max_edge_per_sector)

    # Suppression: +-5 ring neighbors of an edge are excluded from surf
    # (picked_points, cpp:115-143).
    suppressed = edge_mask
    for s in deltas:
        suppressed = suppressed | (jnp.roll(edge_mask, s) & (jnp.roll(ring, s) == ring))

    surf_mask = eligible & ~suppressed

    # Un-sort masks back to original point order.
    inv = jnp.zeros((n,), jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    edge_orig = edge_mask[inv]
    surf_orig = surf_mask[inv]
    return LoamFeatures(
        edge=pc._replace(mask=edge_orig),
        surf=pc._replace(mask=surf_orig),
    )


class LoamTarget(NamedTuple):
    edge: icp.IcpTarget
    surf: icp.IcpTarget


def set_target(edge_pc: PointCloud, surf_pc: PointCloud, opts: LoamOption,
               origin=None) -> LoamTarget:
    """SetInputTarget (loam_registration.cpp:22-36)."""
    return LoamTarget(
        edge=icp.set_target(edge_pc, opts.edge_icp, origin),
        surf=icp.set_target(surf_pc, opts.surf_icp, origin),
    )


@functools.partial(jax.jit, static_argnames=("opts",))
def scan_match(target: LoamTarget, opts: LoamOption,
               edge_src: PointCloud, surf_src: PointCloud, R0, t0) -> icp.MatchResult:
    """Fused GN loop (loam_registration.cpp:38-99): H = H_edge + H_surf,
    B = B_edge + B_surf per iteration, joint solve, eps=1e-3."""

    def cond(state):
        it, R, t, done, _, _ = state
        return (it < opts.max_iteration) & (~done)

    def body(state):
        it, R, t, _, _, _ = state
        H = jnp.zeros((6, 6), jnp.float32)
        B = jnp.zeros((6,), jnp.float32)
        n_eff = jnp.int32(0)
        chi2 = jnp.float32(0.0)
        if opts.use_surf_points:
            Hs, Bs, ns, cs = icp.compute_h_and_b(target.surf, opts.surf_icp, surf_src, R, t)
            H, B, n_eff, chi2 = H + Hs, B + Bs, n_eff + ns, chi2 + cs
        if opts.use_edge_points:
            He, Be, ne, ce = icp.compute_h_and_b(target.edge, opts.edge_icp, edge_src, R, t)
            H, B, n_eff, chi2 = H + He, B + Be, n_eff + ne, chi2 + ce
        ok = n_eff >= (opts.surf_icp.min_effective_pts + opts.edge_icp.min_effective_pts)
        dx = jnp.where(ok, mathx.solve_gn_6x6(H, B), jnp.zeros(6, dtype=B.dtype))
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        R_new, t_new = lie.se3_retract(R, t, dx)
        converged = ok & (jnp.linalg.norm(dx) < opts.eps)
        return (it + 1, R_new, t_new, converged, n_eff, chi2)

    init = (jnp.int32(0), jnp.asarray(R0, jnp.float32), jnp.asarray(t0, jnp.float32),
            jnp.bool_(False), jnp.int32(0), jnp.float32(0.0))
    it, R, t, converged, n_eff, chi2 = jax.lax.while_loop(cond, body, init)
    # pin the output on SO(3) (lie.so3_renormalize docstring)
    return icp.MatchResult(R=lie.so3_renormalize(R), t=t,
                           converged=converged, num_effective=n_eff,
                           iterations=it, chi2=chi2)
