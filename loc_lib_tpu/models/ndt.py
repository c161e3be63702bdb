"""NDT scan matching: direct and incremental voxelized-Gaussian alignment.

Rebuild of the reference `NdtRegistration`
(/root/reference/LocUtils/src/model/matching/3d/ndt/ndt_registration.cpp).

Direct mode (SetDirectNdtTargetCloud + AlignNdt, cpp:86-148, 374-464): one
`voxel_stats` segment-reduce builds per-voxel (count, mean, cov); voxels with
count > min_pts_in_voxel keep an information matrix from the SVD-clamped
covariance inverse (cpp:116-131). Alignment gathers the NEARBY6 stencil per
point, gates residuals by the chi2 threshold res_outlier_th (cpp:418-424),
and — faithfully to the reference — accumulates the UNWEIGHTED system
H += J^T J, b += -J^T e (cpp:425-433; the info matrix is used only for
gating in direct mode). Also faithful: direct mode counts every source point
as "effective" regardless of matches (cpp:434, a reference quirk).

Incremental mode (SetIncNdtTargetCloud + AlignIncNdt, cpp:150-236, 262-372):
a bounded voxel table updated per keyframe. NOTE a documented deviation: the
reference re-sets `flag_first_scan_ = true` after every update
(cpp:180), which accidentally makes every voxel rebuild from the latest
scan only and leaves its Gaussian-merge branch (UpdateVoxel, cpp:203-236)
dead. We implement the clearly *intended* semantics: moment-matched merge via
math::UpdateMeanAndCov (math_utils.h:88-98), freeze voxels past
max_pts_in_voxel, estimate once count > min_pts_in_voxel. The reference's
exact LRU (std::list splice, cpp:158-171) is replaced by an order-free
epoch-stamped eviction (evict least-recently-touched) that is sort/reduce
friendly; weighted accumulation H += J^T info J matches cpp:344-347.

The voxel membership uses the C++ truncation cast semantics
(`(pt * inv).cast<int>()`, cpp:98/295) via mode="trunc".
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.pointcloud import PointCloud
from ..ops import linearize, voxel
from ..utils import lie, mathx


@dataclasses.dataclass(frozen=True)
class NdtOptions:
    """Mirror of NdtOptions (ndt_registration.hpp:27-42)."""

    method: str = "direct"            # direct | incremental
    voxel_size: float = 1.0
    min_pts_in_voxel: int = 3         # strictly greater-than gate (cpp:110)
    max_pts_in_voxel: int = 50
    nearby: str = "nearby6"           # center | nearby6
    max_iteration: int = 20
    eps: float = 1e-2
    res_outlier_th: float = 20.0
    min_effective_pts: int = 10
    # Device-side capacity of the incremental voxel table (reference LRU
    # capacity_=100000, hpp:37). Power of two for cheap padding.
    map_capacity: int = 65536
    # Fused fast path: O(1) dense voxel lookup (one gather instead of a
    # 17-round binary search per stencil probe) + the linearization over
    # Cholesky-packed voxel info (ops/linearize.ndt). use_fused=False keeps the
    # jnp-level oracle path (tests pin the two to identical H/b).
    use_fused: bool = True
    dense_dims: tuple = (256, 256, 64)
    # voxel-membership binning: 'trunc' replicates the reference's C++ cast
    # (cpp:98/295); 'floor' is used when the moment table backs a derived
    # ICP plane target (icp.target_from_moment_table), whose queries bin by
    # floor
    bin_mode: str = "trunc"


def _stencil(opts: NdtOptions) -> jax.Array:
    return voxel.NEARBY6 if opts.nearby == "nearby6" else voxel.CENTER1


class NdtMap(NamedTuple):
    """Sorted voxel-Gaussian table (both modes).

    keys      : (V,) int32 sorted (INVALID_KEY padded)
    count     : (V,) float32 total points absorbed
    mean      : (V, 3)
    cov       : (V, 3, 3)
    info      : (V, 3, 3)
    estimated : (V,) bool — Gaussian ready for matching
    age       : (V,) int32 — epoch last touched (incremental eviction)
    epoch     : () int32 — number of updates applied
    origin    : (3,) float32 key-window origin
    packed    : (V, 13) [mu(3), W(9) row-major sqrt factor, est(1)] — ONE row
                gather per stencil probe feeds ops/linearize.ndt
                (None when opts.use_fused=False)
    dense_table, dense_lo : O(1) voxel->slot index (ops.voxel.DenseIndex
                fields, flattened here so NdtMap stays a flat pytree)
    """

    keys: jax.Array
    count: jax.Array
    mean: jax.Array
    cov: jax.Array
    info: jax.Array
    estimated: jax.Array
    age: jax.Array
    epoch: jax.Array
    origin: jax.Array
    packed: Optional[jax.Array] = None
    dense_table: Optional[jax.Array] = None
    dense_lo: Optional[jax.Array] = None


def _finalize_map(m: NdtMap, opts: NdtOptions) -> NdtMap:
    """Attach the fused-path acceleration structures: square-root-factored
    rows (info = W W^T via Cholesky, so the kernel's |W^T e|^2 IS the
    reference's chi2 gate e^T info e) and the dense O(1) slot index."""
    if not opts.use_fused:
        return m
    L = mathx.cholesky_3x3(jnp.where(m.estimated[:, None, None], m.info, 0.0))
    W = mathx.cholesky_3x3_unpack(L).reshape(-1, 9)   # row-major full 3x3
    packed = jnp.concatenate(
        [m.mean, W, m.estimated[:, None].astype(jnp.float32)], axis=1)
    dense = voxel.build_dense_index(m.keys, dims=opts.dense_dims)
    return m._replace(packed=packed, dense_table=dense.table,
                      dense_lo=dense.lo)


# ---------------------------------------------------------------------------
# Direct map build
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("opts",))
def build_direct(pc: PointCloud, opts: NdtOptions, origin=None) -> NdtMap:
    """SetDirectNdtTargetCloud (cpp:86-148) as one segment reduce."""
    if origin is None:
        origin = jnp.zeros((3,), dtype=jnp.float32)
    stats = voxel.voxel_stats(pc, opts.voxel_size, origin, mode=opts.bin_mode)
    keep = stats.count > opts.min_pts_in_voxel        # strict > (cpp:110)
    info = mathx.clamped_inverse_3x3(stats.cov)
    keys = jnp.where(keep, stats.keys, voxel.INVALID_KEY)
    # re-sort so dropped voxels sink to the end and keys stay searchsorted-able
    order = jnp.argsort(keys)
    return _finalize_map(NdtMap(
        keys=keys[order],
        count=stats.count[order],
        mean=stats.mean[order],
        cov=stats.cov[order],
        info=info[order],
        estimated=keep[order],
        age=jnp.zeros_like(stats.count, dtype=jnp.int32),
        epoch=jnp.int32(1),
        origin=origin,
    ), opts)


# ---------------------------------------------------------------------------
# Incremental map update
# ---------------------------------------------------------------------------

def empty_incremental(opts: NdtOptions, origin=None) -> NdtMap:
    v = opts.map_capacity
    if origin is None:
        origin = jnp.zeros((3,), dtype=jnp.float32)
    return _finalize_map(NdtMap(
        keys=jnp.full((v,), voxel.INVALID_KEY, dtype=jnp.int32),
        count=jnp.zeros((v,), dtype=jnp.float32),
        mean=jnp.zeros((v, 3), dtype=jnp.float32),
        cov=jnp.zeros((v, 3, 3), dtype=jnp.float32),
        info=jnp.zeros((v, 3, 3), dtype=jnp.float32),
        estimated=jnp.zeros((v,), dtype=bool),
        age=jnp.zeros((v,), dtype=jnp.int32),
        epoch=jnp.int32(0),
        origin=origin,
    ), opts)


@functools.partial(jax.jit, static_argnames=("opts",))
def update_incremental(m: NdtMap, pc: PointCloud, opts: NdtOptions) -> NdtMap:
    """Absorb a new scan into the bounded voxel table.

    Merge = concat (map entries, scan-voxel stats) -> sort by key -> pairwise
    moment merge of equal-key neighbors -> evict by age down to capacity ->
    re-sort by key. Replaces the sequential LRU walk (cpp:150-180).
    """
    v = opts.map_capacity
    epoch = m.epoch + 1
    stats = voxel.voxel_stats(pc, opts.voxel_size, m.origin, mode=opts.bin_mode)
    s_valid = stats.count > 0

    # Concatenate map rows and scan rows; scan rows carry tag=1 so they sort
    # immediately after an equal-key map row.
    keys = jnp.concatenate([m.keys, jnp.where(s_valid, stats.keys, voxel.INVALID_KEY)])
    cnt = jnp.concatenate([m.count, stats.count])
    mean = jnp.concatenate([m.mean, stats.mean])
    cov = jnp.concatenate([m.cov, stats.cov])
    est = jnp.concatenate([m.estimated, jnp.zeros_like(s_valid)])
    age = jnp.concatenate([m.age, jnp.where(s_valid, epoch, 0)])
    tag = jnp.concatenate(
        [jnp.zeros_like(m.keys), jnp.ones_like(stats.keys)]
    )

    # Stable sort by key keeps map row before scan row for equal keys.
    order = jnp.lexsort((tag, keys))
    keys, cnt, mean, cov, est, age, tag = (
        x[order] for x in (keys, cnt, mean, cov, est, age, tag)
    )

    # A scan row whose left neighbor has the same key merges into it.
    prev_same = jnp.concatenate(
        [jnp.zeros((1,), bool), (keys[1:] == keys[:-1]) & (keys[1:] != voxel.INVALID_KEY)]
    )
    merge_into_prev = prev_same & (tag == 1)

    # Shift scan-row stats onto the map row to their left.
    nxt = lambda x: jnp.concatenate([x[1:], jnp.zeros_like(x[:1])])
    nm_cnt, nm_mean, nm_cov = nxt(cnt), nxt(mean), nxt(cov)
    absorb = jnp.concatenate([merge_into_prev[1:], jnp.zeros((1,), bool)])

    # Frozen voxels (estimated & over the point cap) ignore new points
    # (UpdateVoxel early-return, cpp:203-205).
    frozen = est & (cnt > opts.max_pts_in_voxel)
    do_merge = absorb & ~frozen
    new_mean, new_cov = mathx.merge_gaussian(cnt, mean, cov, jnp.maximum(nm_cnt, 1.0), nm_mean, nm_cov)
    cnt2 = jnp.where(do_merge, cnt + nm_cnt, cnt)
    mean2 = jnp.where(do_merge[:, None], new_mean, mean)
    cov2 = jnp.where(do_merge[:, None, None], new_cov, cov)
    touched = absorb | (tag == 1)
    age2 = jnp.where(touched, epoch, age)

    # Kill merged-away scan rows.
    keys2 = jnp.where(merge_into_prev, voxel.INVALID_KEY, keys)
    alive = keys2 != voxel.INVALID_KEY

    # Evict: keep the `v` most-recently-touched live rows.
    # Sort by (dead, -age): live & newest first.
    evict_rank = jnp.where(alive, -age2, jnp.iinfo(jnp.int32).max)
    keep_order = jnp.argsort(evict_rank)[:v]
    keys3, cnt3, mean3, cov3, age3, est3 = (
        x[keep_order] for x in (keys2, cnt2, mean2, cov2, age2, est))

    # Final key sort for searchsorted lookups.
    final = jnp.argsort(keys3)
    keys4, cnt4, mean4, cov4, age4, est_c = (
        x[final] for x in (keys3, cnt3, mean3, cov3, age3, est3))

    # once estimated, stays estimated (ndt_estimated_ latch, cpp:196/208);
    # first scan estimates everything incl. single-point voxels (cpp:186-199)
    first = m.epoch == 0
    est4 = (keys4 != voxel.INVALID_KEY) & (
        est_c | (cnt4 > opts.min_pts_in_voxel) | (first & (cnt4 >= 1)))

    single = cnt4 <= 1.0
    info_single = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32) * 1e2, cov4.shape)
    info_est = mathx.clamped_inverse_3x3(cov4)
    info4 = jnp.where(single[:, None, None], info_single, info_est)
    info4 = jnp.where(est4[:, None, None], info4, 0.0)

    return _finalize_map(
        NdtMap(keys=keys4, count=cnt4, mean=mean4, cov=cov4, info=info4,
               estimated=est4, age=age4, epoch=epoch, origin=m.origin), opts)


@functools.partial(jax.jit, static_argnames=("opts",))
def rebuild_from_moments(keys, cnt, mean, cov, est, age, epoch, origin,
                         opts: NdtOptions) -> NdtMap:
    """Re-assemble a bounded voxel table from an arbitrary multiset of
    moment rows (keys may repeat; INVALID_KEY rows are dropped).

    The general-K sibling of `update_incremental`'s pairwise merge: sort
    by key, segment-reduce the count-weighted first/second moments of
    equal-key runs (any number of collisions merge exactly), evict by age
    to opts.map_capacity, recompute info/packed/dense. Built for the
    pose-graph correction write-through of the SHARDED map
    (parallel/map_shard.apply_correction_sharded): a rigid correction
    moves voxels across slab boundaries and can map two voxels onto one
    key, both of which this handles; also the re-partition primitive for
    slab imbalance (LioSharded docstring)."""
    v = opts.map_capacity
    n = keys.shape[0]
    order = jnp.argsort(keys)
    k, c, mu, cv, e, a = (x[order] for x in (keys, cnt, mean, cov, est, age))
    c = jnp.where(k != voxel.INVALID_KEY, c, 0.0)
    new_seg = jnp.concatenate(
        [jnp.ones((1,), bool), k[1:] != k[:-1]])
    seg = jnp.cumsum(new_seg.astype(jnp.int32)) - 1          # (n,) 0-based
    c_sum = jax.ops.segment_sum(c, seg, num_segments=n)
    s1 = jax.ops.segment_sum(c[:, None] * mu, seg, num_segments=n)
    # UNBIASED covariance convention throughout (voxel_stats divides by
    # n-1, math_utils.h:55-72): raw second moment of a row is
    # (c-1) cov + c mu mu^T, and the merged unbiased cov divides by
    # (c_sum - 1). Rebuilding an unsplit row set is then an exact identity.
    s2 = jax.ops.segment_sum(
        jnp.maximum(c - 1.0, 0.0)[:, None, None] * cv
        + c[:, None, None] * mu[:, :, None] * mu[:, None, :],
        seg, num_segments=n)
    mean_m = s1 / jnp.maximum(c_sum, 1.0)[:, None]
    cov_m = (s2 - c_sum[:, None, None]
             * mean_m[:, :, None] * mean_m[:, None, :]) \
        / jnp.maximum(c_sum - 1.0, 1.0)[:, None, None]
    key_m = jax.ops.segment_max(k, seg, num_segments=n)
    est_m = jax.ops.segment_max(e.astype(jnp.int32), seg, num_segments=n) > 0
    age_m = jax.ops.segment_max(a, seg, num_segments=n)
    live = (key_m != voxel.INVALID_KEY) & (c_sum > 0)
    key_m = jnp.where(live, key_m, voxel.INVALID_KEY)

    # evict by age down to capacity, then final key sort
    evict_rank = jnp.where(live, -age_m, jnp.iinfo(jnp.int32).max)
    keep = jnp.argsort(evict_rank)[:v]
    k3, c3, mu3, cv3, e3, a3 = (x[keep] for x in
                                (key_m, c_sum, mean_m, cov_m, est_m, age_m))
    final = jnp.argsort(k3)
    k4, c4, mu4, cv4, e4, a4 = (x[final] for x in (k3, c3, mu3, cv3, e3, a3))
    e4 = (k4 != voxel.INVALID_KEY) & (e4 | (c4 > opts.min_pts_in_voxel))
    single = c4 <= 1.0
    info_single = jnp.broadcast_to(
        jnp.eye(3, dtype=jnp.float32) * 1e2, cv4.shape)
    info4 = jnp.where(single[:, None, None], info_single,
                      mathx.clamped_inverse_3x3(cv4))
    info4 = jnp.where(e4[:, None, None], info4, 0.0)
    return _finalize_map(
        NdtMap(keys=k4, count=c4, mean=mu4, cov=cv4, info=info4,
               estimated=e4, age=a4, epoch=jnp.asarray(epoch, jnp.int32),
               origin=jnp.asarray(origin, jnp.float32)), opts)


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------

class MatchResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    converged: jax.Array
    num_effective: jax.Array
    iterations: jax.Array
    chi2: jax.Array


def _lookup(m: NdtMap, query_keys: jax.Array):
    slot = jnp.searchsorted(m.keys, query_keys, side="left", method="scan_unrolled")
    slot = jnp.minimum(slot, m.keys.shape[0] - 1)
    found = (m.keys[slot] == query_keys) & (query_keys != voxel.INVALID_KEY)
    return slot.astype(jnp.int32), found


def _ndt_terms(m: NdtMap, opts: NdtOptions, src: PointCloud, R, t, weighted: bool):
    """All residuals of one GN iteration, batched over points x stencil."""
    q = src.xyz
    qs = q @ R.T + t
    qc = voxel.voxel_coords(qs, 1.0 / opts.voxel_size, m.origin, mode=opts.bin_mode)
    st = _stencil(opts)
    nb_keys = voxel.coords_to_key(qc[:, None, :] + st[None, :, :], src.mask[:, None])

    if opts.use_fused and m.packed is not None:
        # O(1) dense lookup + ONE (N, S, 13) row gather, then residual,
        # chi2 gate, Jacobian and H/b from the packed factors in one pass
        dense = voxel.DenseIndex(table=m.dense_table, lo=m.dense_lo)
        slot, found = voxel.lookup_dense(dense, opts.dense_dims, nb_keys)
        rows = m.packed[slot]                            # (N, S, 13)
        valid = (found & (rows[..., 12] > 0.5)).astype(jnp.float32)
        return linearize.ndt(q, qs, rows[..., 0:3], rows[..., 3:12], valid,
                             R, opts.res_outlier_th, weighted)

    slot, found = _lookup(m, nb_keys)                    # (N, S)
    found = found & m.estimated[slot]
    mu = m.mean[slot]                                    # (N, S, 3)
    info = m.info[slot]                                  # (N, S, 3, 3)
    e = qs[:, None, :] - mu                              # (N, S, 3)
    res = jnp.einsum("nsi,nsij,nsj->ns", e, info, e)
    ok = found & jnp.isfinite(res) & (res <= opts.res_outlier_th)

    # J = [-R hat(q), I] per point, shared across the stencil (cpp:330-332)
    Rhatq = jnp.einsum("ij,njk->nik", R, lie.hat(q))     # (N, 3, 3)
    J = jnp.concatenate(
        [-Rhatq, jnp.broadcast_to(jnp.eye(3, dtype=q.dtype), Rhatq.shape)], axis=-1
    )                                                    # (N, 3, 6)
    w = ok.astype(q.dtype)                               # (N, S)
    if weighted:
        # H += J^T info J ; b += -J^T info e  (cpp:344-347)
        infoJ = jnp.einsum("nsij,njk->nsik", info, J)    # (N, S, 3, 6)
        infoJ = infoJ * w[:, :, None, None]
        H = jnp.einsum("nij,nsik->jk", J, infoJ)
        b = -jnp.einsum("nsij,nsi->j", infoJ, e)
        chi2 = jnp.sum(res * w)
    else:
        # direct mode: unweighted (cpp:425-433)
        Jw = J[:, None, :, :] * w[:, :, None, None]      # (N, S, 3, 6)
        H = jnp.einsum("nij,nsik->jk", J, Jw)
        b = -jnp.einsum("nsij,nsi->j", Jw, e)
        chi2 = jnp.sum(jnp.sum(e * e, axis=-1) * w)
    n_res = jnp.sum(ok)
    return H, b, n_res, chi2


@functools.partial(jax.jit, static_argnames=("opts",))
def scan_match(m: NdtMap, opts: NdtOptions, src: PointCloud, R0, t0) -> MatchResult:
    """AlignNdt / AlignIncNdt (cpp:262-372, 374-464)."""
    weighted = opts.method == "incremental"

    def cond(state):
        it, R, t, done, _, _ = state
        return (it < opts.max_iteration) & (~done)

    def body(state):
        it, R, t, _, _, _ = state
        H, b, n_res, chi2 = _ndt_terms(m, opts, src, R, t, weighted)
        if weighted:
            n_eff = n_res                       # per-residual count (cpp:341)
        else:
            n_eff = src.count()                 # per-point quirk (cpp:434)
        ok = n_eff >= opts.min_effective_pts
        dx = jnp.where(ok, mathx.solve_gn_6x6(H, b), jnp.zeros(6, dtype=b.dtype))
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        R_new, t_new = lie.se3_retract(R, t, dx)
        converged = ok & (jnp.linalg.norm(dx) < opts.eps)
        return (it + 1, R_new, t_new, converged, n_res, chi2)

    init = (jnp.int32(0), jnp.asarray(R0, jnp.float32), jnp.asarray(t0, jnp.float32),
            jnp.bool_(False), jnp.int32(0), jnp.float32(0.0))
    it, R, t, converged, n_eff, chi2 = jax.lax.while_loop(cond, body, init)
    # pin the output on SO(3): float32 retraction defects otherwise feed
    # back through odometry-only prediction and grow exponentially
    # (lie.so3_renormalize docstring)
    return MatchResult(R=lie.so3_renormalize(R), t=t, converged=converged,
                       num_effective=n_eff, iterations=it, chi2=chi2)


@functools.partial(jax.jit, static_argnames=("opts",))
def get_fitness_score(m: NdtMap, opts: NdtOptions, src: PointCloud, R, t,
                      max_range: float = 1.0):
    """GetFitnessScore for voxel-Gaussian maps (matching_interface.h:52; the
    reference's NdtRegistration::GetFitnessScore is a 0-return stub,
    ndt_registration.cpp:466-471): mean squared distance of each transformed
    source point to its nearest estimated voxel CENTROID among the NEARBY6
    stencil, over matches within `max_range`. Lower is better; +inf when
    nothing matches. Also serves moment-table-derived ICP targets
    (icp.target_from_moment_table), whose minimal grid carrier has no point
    buckets for icp.get_fitness_score's exact NN."""
    qs = src.xyz @ R.T + t
    qc = voxel.voxel_coords(qs, 1.0 / opts.voxel_size, m.origin,
                            mode=opts.bin_mode)
    nb_keys = voxel.coords_to_key(
        qc[:, None, :] + voxel.NEARBY6[None, :, :], src.mask[:, None])
    slot, found = _lookup(m, nb_keys)
    found = found & m.estimated[slot]
    d2 = jnp.sum((m.mean[slot] - qs[:, None, :]) ** 2, axis=-1)
    d2 = jnp.where(found, d2, jnp.inf)
    d2min = jnp.min(d2, axis=1)
    eff = jnp.isfinite(d2min) & (d2min <= max_range * max_range) & src.mask
    n = jnp.sum(eff.astype(jnp.float32))
    return jnp.where(n > 0,
                     jnp.sum(jnp.where(eff, d2min, 0.0)) / jnp.maximum(n, 1.0),
                     jnp.inf)
