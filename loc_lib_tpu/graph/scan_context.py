"""ScanContext: polar max-height descriptor + loop-closure retrieval.

The reference computes the descriptor (/root/reference/LocUtils/src/model/
loop_closure/scan_context.cpp:52-188: ring=20 x sector=60 grid of per-cell
max z) but its retrieval — `DetectLoopClosureID`, the ring-key database, the
column-shift alignment — is an EMPTY STUB (scan_context.cpp:190-203;
SURVEY.md section 2). This module finishes the method as published
(Kim & Kim, ICRA 2018), batched for the accelerator:

  * `descriptor`: one scatter-max over all points -> (R, S) grid.
  * `ring_key`:   per-ring occupancy mean -> (R,) rotation-invariant key.
  * `detect_loop`: ring-key L2 candidate gate, then the full descriptor
    distance = min over all S column shifts of the mean per-column cosine
    distance — computed for ALL candidates x ALL shifts as one batched
    einsum (the O(candidates * 60) loop the CPU method dreads is a single
    tensor contraction here).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.pointcloud import PointCloud


@dataclasses.dataclass(frozen=True)
class ScanContextOptions:
    """Mirror of ScanContextOptions (scan_context.hpp:26-49)."""

    num_ring: int = 20
    num_sector: int = 60
    max_radius: float = 80.0
    search_ratio: float = 0.1        # fraction of DB as ring-key candidates
    dist_threshold: float = 0.13     # descriptor distance acceptance gate
    exclude_recent: int = 30         # don't match the most recent frames


@functools.partial(jax.jit, static_argnames=("opts",))
def descriptor(pc: PointCloud, opts: ScanContextOptions = ScanContextOptions()) -> jax.Array:
    """(R, S) polar max-height grid (MakeScancontext, scan_context.cpp:52-130).

    Cell value = max point z in the (ring, sector) bin, 0 if empty; z is
    lifted by +2 m like the reference (lidar height guard, cpp:96)."""
    x, y, z = pc.xyz[:, 0], pc.xyz[:, 1], pc.xyz[:, 2]
    r = jnp.sqrt(x * x + y * y)
    theta = jnp.mod(jnp.arctan2(y, x), 2.0 * jnp.pi)    # xy2theta (cpp:74)
    ring = jnp.clip((r / opts.max_radius * opts.num_ring).astype(jnp.int32),
                    0, opts.num_ring - 1)
    sector = jnp.clip((theta / (2 * jnp.pi) * opts.num_sector).astype(jnp.int32),
                      0, opts.num_sector - 1)
    ok = pc.mask & (r <= opts.max_radius)
    flat = jnp.where(ok, ring * opts.num_sector + sector,
                     opts.num_ring * opts.num_sector)
    zz = jnp.where(ok, z + 2.0, -jnp.inf)
    grid = jnp.full((opts.num_ring * opts.num_sector + 1,), -jnp.inf, jnp.float32)
    grid = grid.at[flat].max(zz)
    grid = jnp.where(jnp.isfinite(grid), grid, 0.0)
    return grid[:-1].reshape(opts.num_ring, opts.num_sector)


def ring_key(desc: jax.Array) -> jax.Array:
    """(R,) rotation-invariant key: per-ring occupancy ratio."""
    return jnp.mean((desc != 0.0).astype(jnp.float32), axis=-1)


def _shifted_distance(q: jax.Array, db: jax.Array) -> jax.Array:
    """Min-over-shifts cosine distance between query (R, S) and each DB
    descriptor (N, R, S): returns (N,)."""
    s = q.shape[-1]
    # all S cyclic shifts of the query: (S, R, S)
    shifts = jnp.stack([jnp.roll(q, k, axis=-1) for k in range(s)])
    # per-column cosine similarity, averaged over non-degenerate columns
    qn = jnp.linalg.norm(shifts, axis=-2) + 1e-12          # (S, S) per column
    dn = jnp.linalg.norm(db, axis=-2) + 1e-12              # (N, S)
    dots = jnp.einsum("krs,nrs->nks", shifts, db)          # (N, S, S)
    cos = dots / (qn[None] * dn[:, None])
    valid = (jnp.linalg.norm(shifts, axis=-2)[None] > 1e-9) & \
        (dn[:, None] > 1e-9)
    sim = jnp.sum(jnp.where(valid, cos, 0.0), axis=-1) / jnp.maximum(
        jnp.sum(valid, axis=-1), 1)
    return 1.0 - jnp.max(sim, axis=-1)                     # (N,)


class LoopResult(NamedTuple):
    index: jax.Array      # () int32 matched frame id, -1 if none
    distance: jax.Array   # () float32 descriptor distance
    found: jax.Array      # () bool


@functools.partial(jax.jit, static_argnames=("opts", "topk"))
def detect_loop_topk(query_desc: jax.Array, db_desc: jax.Array,
                     db_keys: jax.Array, db_ids: jax.Array,
                     db_count: jax.Array,
                     opts: ScanContextOptions = ScanContextOptions(),
                     topk: int = 1) -> LoopResult:
    """`detect_loop` generalized to the `topk` best matches — every array
    of the returned LoopResult has a leading (topk,) axis, best first.
    Entries past the number of acceptable matches carry index=-1 /
    found=False. All candidates' shifted distances are computed in the same
    single contraction as the 1-best path, so topk > 1 costs one extra
    top_k; the consumer is the BATCHED loop re-registration
    (slam3d: K candidate keyframes re-registered in one scan_match_batch
    program instead of the reference's one-probe-at-a-time loop,
    icp_registration.cpp:161-213)."""
    eligible = (db_ids >= 0) & (db_ids < db_count - opts.exclude_recent)

    qk = ring_key(query_desc)
    key_d2 = jnp.sum((db_keys - qk) ** 2, axis=-1)
    key_d2 = jnp.where(eligible, key_d2, jnp.inf)

    # ring-key gate: keep the best ~search_ratio * N candidates
    n = db_desc.shape[0]
    k = max(1, int(opts.search_ratio * n))
    top_d2, top_idx = jax.lax.top_k(-key_d2, k)
    cand_ok = jnp.isfinite(-top_d2)

    dist = _shifted_distance(query_desc, db_desc[top_idx])  # (k,)
    dist = jnp.where(cand_ok, dist, jnp.inf)
    kk = min(topk, k)
    neg_best, order = jax.lax.top_k(-dist, kk)
    best_dist = -neg_best                                   # (kk,) ascending
    found = jnp.isfinite(best_dist) & (best_dist < opts.dist_threshold)
    ids = jnp.where(found, db_ids[top_idx[order]], -1).astype(jnp.int32)
    if kk < topk:  # DB smaller than the ask: pad with not-found lanes
        pad = topk - kk
        ids = jnp.concatenate([ids, jnp.full((pad,), -1, jnp.int32)])
        best_dist = jnp.concatenate([best_dist,
                                     jnp.full((pad,), jnp.inf, jnp.float32)])
        found = jnp.concatenate([found, jnp.zeros((pad,), bool)])
    return LoopResult(index=ids, distance=best_dist, found=found)


@functools.partial(jax.jit, static_argnames=("opts",))
def detect_loop(query_desc: jax.Array, db_desc: jax.Array, db_keys: jax.Array,
                db_ids: jax.Array, db_count: jax.Array,
                opts: ScanContextOptions = ScanContextOptions()) -> LoopResult:
    """DetectLoopClosureID done properly: db_desc (N, R, S) padded database,
    db_keys (N, R), db_ids (N,) per-slot insertion ids (-1 = empty slot; the
    DB is a ring buffer, so slot order is NOT insertion order at capacity),
    db_count = total descriptors ever inserted. The most recent
    `exclude_recent` insertions are excluded (standard ScanContext practice —
    the reference's submap_gap_ analog, loop_closing.cpp:58). The returned
    `index` is the matched INSERTION id."""
    res = detect_loop_topk(query_desc, db_desc, db_keys, db_ids, db_count,
                           opts, topk=1)
    return LoopResult(index=res.index[0], distance=res.distance[0],
                      found=res.found[0])


@functools.partial(jax.jit, static_argnames=("opts",),
                   donate_argnums=(0, 1, 2))
def _db_insert(desc_db, key_db, id_db, xyz, mask, slot, insert_id,
               opts: ScanContextOptions):
    """Descriptor + ring key computed and scattered into the device-resident
    ring buffer as ONE fixed-shape program (no host round trip); the DB
    buffers are DONATED so the scatter is in place — without donation each
    insert copies the full capacity x R x S table (19.6 MB default)."""
    d = descriptor(PointCloud(xyz=xyz, mask=mask), opts)
    return (desc_db.at[slot].set(d),
            key_db.at[slot].set(ring_key(d)),
            id_db.at[slot].set(insert_id))


class ScanContextDb:
    """Host-side descriptor database (the key-frame DB the reference never
    wrote, scan_context.hpp:83-90).

    A RING BUFFER at capacity: the oldest descriptor is overwritten and the
    eviction is counted in `evicted` (observable, never silent — the same
    discipline as the voxel-layer overflow counters, ops/voxel.py:146-150).
    `add` returns the insertion id; `query` results report insertion ids, so
    callers' id spaces (e.g. keyframe indices) stay stable across evictions.
    """

    def __init__(self, capacity: int = 4096,
                 opts: ScanContextOptions = ScanContextOptions()):
        self.opts = opts
        self.capacity = capacity
        # DEVICE-RESIDENT buffers: a numpy DB re-uploaded per query costs a
        # capacity x R x S transfer (19.6 MB at the 4096 default) on EVERY
        # keyframe; keeping the ring buffer on device makes
        # add() one fixed-shape scatter and query() transfer one descriptor
        self.desc = jnp.zeros((capacity, opts.num_ring, opts.num_sector),
                              jnp.float32)
        self.keys = jnp.zeros((capacity, opts.num_ring), jnp.float32)
        self.ids = jnp.full((capacity,), -1, jnp.int32)
        self.count = 0        # total descriptors ever inserted
        self.evicted = 0      # descriptors overwritten after saturation

    def add(self, pc: PointCloud) -> int:
        slot = self.count % self.capacity
        if self.count >= self.capacity:
            self.evicted += 1
        self.desc, self.keys, self.ids = _db_insert(
            self.desc, self.keys, self.ids, pc.xyz, pc.mask,
            jnp.int32(slot), jnp.int32(self.count), self.opts)
        self.count += 1
        return self.count - 1

    def query(self, pc: PointCloud) -> LoopResult:
        q = descriptor(pc, self.opts)
        return detect_loop(q, self.desc, self.keys,
                           self.ids, jnp.int32(self.count), self.opts)

    def query_topk(self, pc: PointCloud, topk: int) -> LoopResult:
        """Top-`topk` matches, best first (leading (topk,) axis on every
        LoopResult array; unmatched lanes carry index=-1/found=False)."""
        q = descriptor(pc, self.opts)
        return detect_loop_topk(q, self.desc, self.keys,
                                self.ids, jnp.int32(self.count),
                                self.opts, topk=topk)
