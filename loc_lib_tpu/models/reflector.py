"""2D reflective-marker detection, matching, and pose recovery.

The reference declares this component but never implements it: `ReflactorProcess::AddScan`
is an empty body behind an option struct of range-banded intensity
thresholds, target-width gates, and triangle-matching tolerances
(/root/reference/LocUtils/include/LocUtils/model/reflactor/
reflactor_proc.hpp:9-23, src/model/reflactor/reflactor_proc.cpp:19-22).
This module completes it as batched device code, honoring those knobs:

  * `detect_markers` — beams above the range-banded intensity threshold are
    clustered by angular adjacency (segment ops, fixed capacity), cluster
    arc width is gated to the reflective-target width band
    (reflectiveTargetNomalWidthMin/Max), centers come out padded + masked.
  * `match_markers` — pairwise-distance voting (the vectorized form of the
    stub's triangle matching: two detected markers whose separation matches
    a map pair's within `matching_error` vote for both endpoint
    correspondences; a triangle is three mutually consistent pairs, so
    vote-count >= 2 reproduces the triangle criterion without enumerating
    O(K^3 M^3) triples).
  * `estimate_pose` — closed-form SE(2) Kabsch over matched centers.

Everything is fixed-shape and jit-safe; capacities are static options.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ReflectorOptions:
    """Mirror of ReflactorOption (reflactor_proc.hpp:9-23)."""

    # range-banded minimum intensity: (max_range_of_band, min_intensity)
    intensity_bands: tuple = ((0.5, 105.0), (2.0, 70.0), (4.0, 50.0),
                              (6.0, 40.0), (jnp.inf, 30.0))
    width_min: float = 0.025          # reflectiveTargetNomalWidthMin
    width_max: float = 0.085          # reflectiveTargetNomalWidthMax
    matching_error: float = 0.03      # pair-length tolerance [m]
    min_pair_votes: int = 2           # triangle criterion (>=2 consistent pairs)
    recognition_distance: float = 6.0
    max_markers: int = 16             # detection capacity (fixed shape)


class Markers(NamedTuple):
    xy: jax.Array      # (K, 2) marker centers, lidar frame
    weight: jax.Array  # (K,) beams per marker (detection confidence)
    valid: jax.Array   # (K,)


def _band_threshold(opts: ReflectorOptions, rng: jax.Array) -> jax.Array:
    th = jnp.full_like(rng, jnp.inf)
    # walk bands from far to near so nearer (stricter) bands overwrite
    for max_r, min_int in reversed(opts.intensity_bands):
        th = jnp.where(rng <= max_r, min_int, th)
    return th


@functools.partial(jax.jit, static_argnames=("opts",))
def detect_markers(ranges: jax.Array, angles: jax.Array,
                   intensity: jax.Array, valid: jax.Array,
                   opts: ReflectorOptions = ReflectorOptions()) -> Markers:
    """Cluster retro-reflective beams into marker centers.

    ranges/angles/intensity/valid: (B,) beam arrays (angles ascending).
    """
    n = ranges.shape[0]
    hot = (valid & (ranges > 0.0) & (ranges <= opts.recognition_distance)
           & (intensity >= _band_threshold(opts, ranges)))

    # contiguous-run clustering: run id = cumsum of run starts
    prev_hot = jnp.concatenate([jnp.zeros((1,), bool), hot[:-1]])
    start = hot & ~prev_hot
    run_id = jnp.where(hot, jnp.cumsum(start.astype(jnp.int32)) - 1, n)

    xy = jnp.stack([ranges * jnp.cos(angles), ranges * jnp.sin(angles)], -1)
    w = hot.astype(jnp.float32)
    cnt = jax.ops.segment_sum(w, run_id, num_segments=n + 1)[:-1]
    cx = jax.ops.segment_sum(xy * w[:, None], run_id, num_segments=n + 1)[:-1]
    centers = cx / jnp.maximum(cnt, 1.0)[:, None]
    amin = jax.ops.segment_min(jnp.where(hot, angles, jnp.inf), run_id,
                               num_segments=n + 1)[:-1]
    amax = jax.ops.segment_max(jnp.where(hot, angles, -jnp.inf), run_id,
                               num_segments=n + 1)[:-1]
    rmean = jax.ops.segment_sum(ranges * w, run_id, num_segments=n + 1)[:-1] \
        / jnp.maximum(cnt, 1.0)
    # physical arc width of the cluster + one beam step each side
    step = jnp.where(n > 1, jnp.abs(angles[1] - angles[0]), 0.0)
    arc = (amax - amin + step) * rmean
    ok = (cnt > 0) & (arc >= opts.width_min) & (arc <= opts.width_max)

    # compact the best max_markers clusters (by beam count) to fixed capacity
    k = opts.max_markers
    score = jnp.where(ok, cnt, -1.0)
    top = jax.lax.top_k(score, k)[1]
    return Markers(xy=centers[top],
                   weight=cnt[top],
                   valid=score[top] > 0)


class MatchResult(NamedTuple):
    pairs: jax.Array     # (K,) int32: map index per detected marker (-1 none)
    votes: jax.Array     # (K,) int32 consistency votes
    num_matched: jax.Array


@functools.partial(jax.jit, static_argnames=("opts",))
def match_markers(det: Markers, map_xy: jax.Array, map_valid: jax.Array,
                  opts: ReflectorOptions = ReflectorOptions()) -> MatchResult:
    """Pairwise-distance voting (vectorized triangle matching).

    det.xy (K, 2) in the lidar frame, map_xy (M, 2) in the map frame.
    Distances are rigid invariants, so pair (i,j) in the detection whose
    length matches map pair (a,b) within matching_error votes for i->a,j->b
    and i->b,j->a. A marker's best map candidate needs >= min_pair_votes
    (two consistent pairs = a consistent triangle)."""
    K = det.xy.shape[0]
    M = map_xy.shape[0]
    ddet = jnp.linalg.norm(det.xy[:, None, :] - det.xy[None, :, :], axis=-1)
    dmap = jnp.linalg.norm(map_xy[:, None, :] - map_xy[None, :, :], axis=-1)
    vdet = det.valid[:, None] & det.valid[None, :] & ~jnp.eye(K, dtype=bool)
    vmap = map_valid[:, None] & map_valid[None, :] & ~jnp.eye(M, dtype=bool)

    # consistency of det pair (i,j) with map pair (a,b): (K,K,M,M)
    consistent = (jnp.abs(ddet[:, :, None, None] - dmap[None, None, :, :])
                  <= opts.matching_error)
    consistent = consistent & vdet[:, :, None, None] & vmap[None, None, :, :]
    # votes for assignment i->a: sum over j,b of consistency
    votes = jnp.sum(consistent, axis=(1, 3)).astype(jnp.int32)   # (K, M)

    best = jnp.argmax(votes, axis=1).astype(jnp.int32)           # (K,)
    best_v = jnp.take_along_axis(votes, best[:, None], axis=1)[:, 0]
    matched = det.valid & (best_v >= opts.min_pair_votes)
    pairs = jnp.where(matched, best, -1)
    return MatchResult(pairs=pairs, votes=best_v,
                       num_matched=jnp.sum(matched.astype(jnp.int32)))


class PoseFix(NamedTuple):
    theta: jax.Array
    t: jax.Array         # (2,)
    num_inliers: jax.Array
    rmse: jax.Array
    ok: jax.Array


@jax.jit
def estimate_pose(det: Markers, map_xy: jax.Array, match: MatchResult) -> PoseFix:
    """SE(2) Kabsch from matched marker pairs: T maps lidar-frame detections
    onto map-frame markers (the reflector localization fix)."""
    matched = match.pairs >= 0
    w = matched.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    src = det.xy
    dst = map_xy[jnp.maximum(match.pairs, 0)]
    mu_s = jnp.sum(src * w[:, None], 0) / n
    mu_d = jnp.sum(dst * w[:, None], 0) / n
    s = src - mu_s
    d = dst - mu_d
    # 2D Kabsch: theta = atan2(sum cross, sum dot)
    dot = jnp.sum((s[:, 0] * d[:, 0] + s[:, 1] * d[:, 1]) * w)
    crs = jnp.sum((s[:, 0] * d[:, 1] - s[:, 1] * d[:, 0]) * w)
    theta = jnp.arctan2(crs, dot)
    c, si = jnp.cos(theta), jnp.sin(theta)
    R = jnp.array([[c, -si], [si, c]])
    t = mu_d - R @ mu_s
    res = (src @ R.T + t - dst) * w[:, None]
    rmse = jnp.sqrt(jnp.sum(res * res) / n)
    k = jnp.sum(matched.astype(jnp.int32))
    return PoseFix(theta=theta, t=t, num_inliers=k, rmse=rmse,
                   ok=(k >= 2) & jnp.isfinite(rmse))


def process_scan(ranges, angles, intensity, valid, map_xy, map_valid,
                 opts: ReflectorOptions = ReflectorOptions()) -> PoseFix:
    """AddScan, completed: detect -> match -> pose (reflactor_proc.cpp:19-22
    left empty in the reference)."""
    det = detect_markers(ranges, angles, intensity, valid, opts)
    m = match_markers(det, map_xy, map_valid, opts)
    return estimate_pose(det, map_xy, m)
