"""2D submap SLAM: scan matching, submap management, loop closure.

Rebuild of the reference 2D stack (a Cartographer-lite):

  * `Mapping2D` (/root/reference/LocUtils/src/mapping_2d/mapping_2d.cpp):
    per scan — motion guess, GN match into the current submap's likelihood
    field (mapping_2d.cpp:65-130), keyframe test 0.3 m / 15 deg
    (mapping_2d.hpp:73-74), occupancy update + field regen, submap expansion
    when the scan leaves the grid or after 50 keyframes
    (mapping_2d.cpp:154-184).
  * `Submap` (mapping_2d/submap.cpp): pose T_w_s + occupancy + field; new
    submaps are seeded from the last frames of the previous one
    (submap.cpp:14-23).
  * `LoopClosing` (mapping_2d/loop_closing.cpp): distance-gated candidates
    vs historical submaps (15 m, skip the most recent, cpp:52-85);
    re-registration through a multi-resolution field pyramid
    (multi_resolution_likelihood_field.cpp:53-178) with inlier-ratio
    acceptance; SE(2) pose graph (sequential + loop edges, robust kernel,
    two-phase chi2 gating) over submap poses, then frame poses are updated
    through their submaps (loop_closing.cpp:160-255).

Device/host split: field matching, occupancy scatter, EDT, and the pose
graph run as jitted programs; submap lifecycle and loop bookkeeping live in
the host driver, mirroring the reference's object layer.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import grid2d
from ..graph import pose_graph2d as pg2
from ..graph.pose_graph import PgoOptions
from ..utils import lie


@dataclasses.dataclass(frozen=True)
class Mapping2dOptions:
    grid: grid2d.Grid2dOptions = grid2d.Grid2dOptions()
    align: grid2d.Align2dOptions = grid2d.Align2dOptions()
    keyframe_dist: float = 0.3           # mapping_2d.hpp:73
    keyframe_angle_deg: float = 15.0     # mapping_2d.hpp:74
    max_keyframes_in_submap: int = 50    # mapping_2d.cpp:166
    # New submaps are seeded with the last N keyframes of the previous one
    # (SetOccuFromOtherSubmap, submap.cpp:14-23) so matching has a real
    # target right after every expansion instead of a single-scan sliver.
    seed_frames: int = 10
    loop_candidate_radius: float = 15.0  # loop_closing.cpp:69
    loop_submap_gap: int = 1             # loop_closing.cpp:58
    loop_min_inlier_ratio: float = 0.4   # multi_resolution_...cpp:170
    # Plausibility gate on accepted loop matches: reject a re-registration
    # whose implied submap-pair transform deviates from the odometry-implied
    # one by more than this (translation m / rotation rad). The inlier-ratio
    # test alone accepts aliased matches meters off in self-similar worlds
    # (measured: 4.5 m-wrong constraints at ratio >= 0.4 sent the bench
    # trajectory into a feedback spiral); the gate bounds accepted drift
    # correction to what odometry could plausibly have accumulated — the 2D
    # analog of the 3D pose graph's loop_pregate (graph/pose_graph.py).
    loop_max_trans_delta: float = 1.5
    loop_max_rot_delta: float = 0.35
    # A FAILED loop-match attempt against a submap pair is retried only
    # after the robot has moved this far — a new viewpoint gives the match
    # a new chance, re-matching from the same spot just repeats the failure
    # (the reference re-attempts every keyframe, loop_closing.cpp:120-158;
    # each multires attempt costs a full 4-level pyramid alignment).
    loop_retry_move_m: float = 1.0
    # solver="dense": a submap graph is tens of nodes; the one (3M, 3M)
    # dense solve is exact and latency-flat there, while block-sparse PCG
    # spends 25 GN x up-to-250 CG tiny sequential iterations that are pure
    # launch latency on an accelerator at this scale (the two are pinned
    # equal by tests/test_mapping2d.py). PCG remains the right solver for
    # the large 3D keyframe graphs it was built for.
    pgo: PgoOptions = PgoOptions(solver="dense")
    # multi-res pyramid: coarse-to-fine pooling factors over the base field
    pyramid_factors: tuple = (8, 4, 2, 1)
    # Device-resident engine only: how many ARCHIVED submaps keep their
    # grid/field in HBM (~9 MB each; zero-copy archive). Older archives
    # spill to host numpy and re-upload if a loop candidate matches them.
    archived_device_submaps: int = 12
    # When the GN multires loop registration fails its inlier-ratio
    # acceptance, retry the pyramid once with the Levenberg-Marquardt
    # aligner (grid2d.align_lm — the reference's own loop-registration
    # solver is g2o LM, multi_resolution_likelihood_field.cpp:53-178):
    # damped accept/reject steps recover wide-off initializations GN
    # overshoots. Costs one extra executable (warmed alongside the GN one
    # in Mapping2DDevice) and one extra pyramid run per FAILED candidate.
    lm_fallback: bool = True


# Host-side SE(2) bookkeeping in plain numpy: these are 3-DoF scalar ops,
# and each device dispatch + scalar pull costs a round trip — routing them
# through jax made the 2D pipeline transfer-bound.

def _np_wrap(a: float) -> float:
    return float((a + np.pi) % (2.0 * np.pi) - np.pi)


def _np_se2_compose(th1, t1, th2, t2):
    c, s = np.cos(th1), np.sin(th1)
    R = np.array([[c, -s], [s, c]], np.float32)
    return _np_wrap(th1 + th2), np.asarray(t1, np.float32) + R @ np.asarray(t2, np.float32)


def _np_se2_inverse(th, t):
    c, s = np.cos(th), np.sin(th)
    Rt = np.array([[c, s], [-s, c]], np.float32)
    return _np_wrap(-th), -(Rt @ np.asarray(t, np.float32))


def _np_se2_apply(th, t, xy):
    c, s = np.cos(th), np.sin(th)
    R = np.array([[c, -s], [s, c]], np.float32)
    return np.asarray(xy, np.float32) @ R.T + np.asarray(t, np.float32)


class Submap:
    """Host-side submap record (Submap, submap.hpp:25-73)."""

    def __init__(self, opts: Mapping2dOptions, theta_ws: float, t_ws: np.ndarray,
                 index: int):
        self.opts = opts
        self.index = index
        self.theta_ws = float(theta_ws)
        self.t_ws = np.asarray(t_ws, np.float32)
        self.grid = grid2d.empty_grid(opts.grid)
        self.field = grid2d.likelihood_field(self.grid, opts.grid)
        self.num_frames = 0
        self.frame_ids: list[int] = []
        # last seed_frames keyframes (scan, valid, world pose) kept for
        # seeding the NEXT submap (submap.cpp:14-23)
        self.recent: list[tuple] = []

    def world_to_submap(self, theta_wb, t_wb):
        return _np_se2_compose(*_np_se2_inverse(self.theta_ws, self.t_ws),
                               theta_wb, t_wb)

    def submap_to_world(self, theta_sb, t_sb):
        return _np_se2_compose(self.theta_ws, self.t_ws, theta_sb, t_sb)

    def add_scan(self, scan_xy, valid, theta_sb, t_sb):
        """AddScanInOccupancyMap (submap.cpp:33-36): pose the scan into the
        submap frame, update occupancy, regenerate the field."""
        th_w, t_w = self.submap_to_world(theta_sb, t_sb)
        self.recent.append((scan_xy, valid, th_w, np.asarray(t_w, np.float32)))
        if len(self.recent) > self.opts.seed_frames:
            self.recent.pop(0)
        # ONE fused device program (occupancy + field) + an explicit sync:
        # the 2D pipeline is host-interactive anyway.
        pts = _np_se2_apply(theta_sb, t_sb, scan_xy)
        self.grid, self.field = grid2d.add_scan_and_field(
            self.grid, self.opts.grid, jnp.asarray(pts), jnp.asarray(valid),
            jnp.asarray(t_sb, jnp.float32))
        jax.block_until_ready(self.field)
        self.num_frames += 1

    def _rasterize(self, scan_xy, valid, theta_sb, t_sb):
        pts = _np_se2_apply(theta_sb, t_sb, scan_xy)
        self.grid = grid2d.add_scan(self.grid, self.opts.grid,
                                    jnp.asarray(pts), jnp.asarray(valid),
                                    jnp.asarray(t_sb, jnp.float32))

    def seed_from(self, other: "Submap") -> None:
        """SetOccuFromOtherSubmap (submap.cpp:14-23): rasterize the previous
        submap's recent keyframes (at their WORLD poses re-expressed in this
        submap's frame) so the new submap isn't an empty matching target.
        All seed scans + the single field regen run as ONE device program
        (grid2d.add_scans_and_field; the stack is padded to seed_frames so
        every expansion hits the same executable)."""
        recent = other.recent[-self.opts.seed_frames:]
        if not recent:
            return
        kmax = self.opts.seed_frames
        b = recent[0][0].shape[0]
        pts = np.zeros((kmax, b, 2), np.float32)
        val = np.zeros((kmax, b), bool)
        orgs = np.zeros((kmax, 2), np.float32)
        for k, (scan_xy, valid, th_w, t_w) in enumerate(recent):
            th_sb, t_sb = self.world_to_submap(th_w, t_w)
            pts[k] = _np_se2_apply(th_sb, t_sb, scan_xy)
            val[k] = valid
            orgs[k] = t_sb
        self.grid, self.field = grid2d.add_scans_and_field(
            self.grid, self.opts.grid, jnp.asarray(pts), jnp.asarray(val),
            jnp.asarray(orgs), jnp.int32(len(recent)))
        jax.block_until_ready(self.field)

    def match_scan(self, scan_xy, valid, theta0_sb, t0_sb) -> grid2d.Align2dResult:
        return grid2d.align_gauss_newton(
            self.field, self.opts.grid, jnp.asarray(scan_xy), jnp.asarray(valid),
            jnp.float32(theta0_sb), jnp.asarray(t0_sb, jnp.float32), self.opts.align)

    def match_multires(self, scan_xy, valid, theta0_sb, t0_sb):
        """Coarse-to-fine alignment through a pooled field pyramid
        (MRLikelihoodField::AlignG2O, multi_resolution_likelihood_field.cpp:
        53-178) — all levels fused into ONE device program
        (_match_multires_jit). Returns (result, accepted)."""
        res = _match_multires_jit(
            self.field, self.opts.grid, self.opts.align,
            self.opts.pyramid_factors, jnp.asarray(scan_xy),
            jnp.asarray(valid), jnp.float32(theta0_sb),
            jnp.asarray(t0_sb, jnp.float32))
        ratio, n_eff = jax.device_get((res.inlier_ratio, res.num_effective))
        ok = (float(ratio) >= self.opts.loop_min_inlier_ratio
              and int(n_eff) >= self.opts.align.min_effective)
        if not ok and self.opts.lm_fallback:
            # LM retry from the ORIGINAL init (Mapping2dOptions.lm_fallback)
            res2 = _match_multires_jit(
                self.field, self.opts.grid,
                dataclasses.replace(self.opts.align, method="lm"),
                self.opts.pyramid_factors, jnp.asarray(scan_xy),
                jnp.asarray(valid), jnp.float32(theta0_sb),
                jnp.asarray(t0_sb, jnp.float32))
            ratio2, n_eff2 = jax.device_get((res2.inlier_ratio,
                                             res2.num_effective))
            ok2 = (float(ratio2) >= self.opts.loop_min_inlier_ratio
                   and int(n_eff2) >= self.opts.align.min_effective)
            if ok2:
                return res2, True
        return res, ok


@functools.partial(jax.jit,
                   static_argnames=("gopts", "aopts", "factors"))
def _match_multires_jit(field, gopts, aopts, factors, scan_xy, valid,
                        th0, t0):
    """All pyramid levels (pool + align per static factor) as one XLA
    program — the loop candidates' 8-call sequence collapsed to 1 (per-call
    executable overhead)."""
    th, t = th0, t0
    res = None
    for f in factors:
        pooled, go = _pooled_field(field, gopts, f)
        res = grid2d.align_gauss_newton(pooled, go, scan_xy, valid,
                                        th, t, aopts)
        th, t = res.theta, res.t
    return res


def _pooled_field(field: jax.Array, gopts: grid2d.Grid2dOptions, factor: int):
    """Min-pool the base distance field by `factor` — equivalent to a field
    built at resolution/factor (distance values rescale with resolution)."""
    if factor == 1:
        return field, gopts
    n = field.shape[0] // factor
    pooled = field[: n * factor, : n * factor].reshape(n, factor, n, factor).min(
        axis=(1, 3)) / factor
    new_opts = dataclasses.replace(
        gopts, image_size=n, resolution=gopts.resolution / factor,
        field_radius=max(2, gopts.field_radius // factor))
    return pooled, new_opts


class LoopConstraint(NamedTuple):
    submap_i: int
    submap_j: int
    theta_ij: float
    t_ij: np.ndarray
    valid: bool


class Mapping2D:
    """Host driver (Mapping2D, mapping_2d.hpp:26-75)."""

    def __init__(self, opts: Mapping2dOptions = Mapping2dOptions()):
        self.opts = opts
        self.submaps: list[Submap] = [Submap(opts, 0.0, np.zeros(2), 0)]
        self.theta_wb = 0.0
        self.t_wb = np.zeros(2, np.float32)
        self.last_theta = 0.0
        self.last_t = np.zeros(2, np.float32)
        self.last_kf_theta = 0.0
        self.last_kf_t = np.zeros(2, np.float32)
        self.frame_count = 0
        self.loops: list[LoopConstraint] = []
        # one constraint per (historical, current) submap pair, mirroring the
        # reference's loop_constraints_ map keyed by the pair
        # (loop_closing.cpp:66-69, 143-145); invalidated pairs may be retried
        self._pair_idx: dict[tuple, int] = {}
        # body position at the last FAILED attempt per pair (retry throttle)
        self._pair_attempt_t: dict[tuple, np.ndarray] = {}
        self.frame_poses: list[tuple[float, np.ndarray]] = []

    # -- per-scan -----------------------------------------------------------
    def process_scan(self, scan_xy: np.ndarray, valid: np.ndarray):
        """ProcessScan (mapping_2d.cpp:65-130). scan_xy in the sensor frame."""
        opts = self.opts
        first = self.frame_count == 0
        # constant-velocity world guess (mapping_2d.cpp:79-85)
        guess_th = self.theta_wb + _np_wrap(self.theta_wb - self.last_theta)
        guess_t = self.t_wb + (self.t_wb - self.last_t)

        cur = self.submaps[-1]
        if not first:
            th0, t0 = cur.world_to_submap(guess_th, guess_t)
            res = cur.match_scan(scan_xy, valid, th0, t0)
            # ONE batched pull of the match result (a round trip per transfer)
            th_m, t_m = jax.device_get((res.theta, res.t))
            th_w, t_w = cur.submap_to_world(float(th_m), t_m)
        else:
            th_w, t_w = self.theta_wb, self.t_wb

        self.last_theta, self.last_t = self.theta_wb, self.t_wb
        self.theta_wb, self.t_wb = float(th_w), np.asarray(t_w, np.float32)
        self.frame_poses.append((self.theta_wb, self.t_wb.copy()))

        if first or self._is_keyframe():
            self.last_kf_theta, self.last_kf_t = self.theta_wb, self.t_wb
            th_sb, t_sb = cur.world_to_submap(self.theta_wb, self.t_wb)
            cur.add_scan(scan_xy, valid, th_sb, t_sb)
            cur.frame_ids.append(self.frame_count)
            self._maybe_expand(scan_xy, valid)
            self._detect_loops(scan_xy, valid)

        self.frame_count += 1
        return self.theta_wb, self.t_wb.copy()

    def _is_keyframe(self) -> bool:
        d = np.linalg.norm(self.t_wb - self.last_kf_t)
        a = abs(_np_wrap(self.theta_wb - self.last_kf_theta))
        return d > self.opts.keyframe_dist or a > np.deg2rad(self.opts.keyframe_angle_deg)

    def _maybe_expand(self, scan_xy, valid):
        """ExpandSubmap triggers (mapping_2d.cpp:154-184). The out-of-bounds
        fraction is pure geometry — computed in host numpy (a device pull
        here costs a round trip per keyframe; grid2d.out_of_bounds_fraction stays as the device-side equivalent
        for jitted callers)."""
        cur = self.submaps[-1]
        th_sb, t_sb = cur.world_to_submap(self.theta_wb, self.t_wb)
        pts = _np_se2_apply(th_sb, t_sb, scan_xy)
        g = self.opts.grid
        px = pts * g.resolution + g.center
        outside = ((px[:, 0] < 0) | (px[:, 0] >= g.image_size)
                   | (px[:, 1] < 0) | (px[:, 1] >= g.image_size))
        nvalid = max(int(np.sum(valid)), 1)
        oob = float(np.sum(outside & np.asarray(valid)) / nvalid)
        if oob > 0.1 or cur.num_frames > self.opts.max_keyframes_in_submap:
            new = Submap(self.opts, self.theta_wb, self.t_wb, len(self.submaps))
            # seed from the previous submap's recent keyframes
            # (ExpandSubmap -> SetOccuFromOtherSubmap, mapping_2d.cpp:164-172)
            # then add the current scan
            new.seed_from(cur)
            new.add_scan(scan_xy, valid, 0.0, np.zeros(2))
            self.submaps.append(new)

    # -- loop closing ---------------------------------------------------------
    def _detect_loops(self, scan_xy, valid):
        """DetectLoopCandidates + MatchInHistorySubmaps (loop_closing.cpp:
        52-158), then optimize."""
        opts = self.opts
        cur = self.submaps[-1]
        found = False
        for sm in self.submaps[: max(0, len(self.submaps) - 1 - opts.loop_submap_gap)]:
            # one valid constraint per submap pair (loop_closing.cpp:66-69):
            # skip pairs already constrained; retried only if invalidated
            pair = (sm.index, cur.index)
            k = self._pair_idx.get(pair)
            if k is not None and self.loops[k].valid:
                continue
            if np.linalg.norm(sm.t_ws - self.t_wb) > opts.loop_candidate_radius:
                continue
            last_t = self._pair_attempt_t.get(pair)
            if (last_t is not None
                    and np.linalg.norm(self.t_wb - last_t)
                    < opts.loop_retry_move_m):
                continue  # same viewpoint as the last failed attempt
            th0, t0 = sm.world_to_submap(self.theta_wb, self.t_wb)
            res, ok = sm.match_multires(scan_xy, valid, th0, t0)
            if not ok:
                self._pair_attempt_t[pair] = self.t_wb.copy()
                continue
            # constraint between submap sm and current submap:
            # T_sm_cur = T_sm_b * T_b_cur, with T_sm_b from the match and
            # T_b_cur = (T_w_b)^-1 T_w_cur
            th_b_cur, t_b_cur = _np_se2_compose(
                *_np_se2_inverse(self.theta_wb, self.t_wb),
                cur.theta_ws, cur.t_ws)
            th_m, t_m = jax.device_get((res.theta, res.t))
            th_ij, t_ij = _np_se2_compose(float(th_m), t_m, th_b_cur, t_b_cur)
            # plausibility gate vs the odometry-implied pair transform
            th_odo, t_odo = _np_se2_compose(
                *_np_se2_inverse(sm.theta_ws, sm.t_ws),
                cur.theta_ws, cur.t_ws)
            if (np.linalg.norm(np.asarray(t_ij) - t_odo)
                    > opts.loop_max_trans_delta
                    or abs(_np_wrap(th_ij - th_odo)) > opts.loop_max_rot_delta):
                self._pair_attempt_t[pair] = self.t_wb.copy()
                continue
            lc = LoopConstraint(
                submap_i=sm.index, submap_j=cur.index,
                theta_ij=float(th_ij), t_ij=np.asarray(t_ij), valid=True)
            if k is None:
                self._pair_idx[pair] = len(self.loops)
                self.loops.append(lc)
            else:
                self.loops[k] = lc
            found = True
        if found:
            self.optimize()

    def optimize(self):
        """Pose-graph over submap poses + write-back
        (loop_closing.cpp:160-255)."""
        m = len(self.submaps)
        if m < 2 or not self.loops:
            return
        # graph build + padding in HOST numpy (pg2.build_graph_np): eager
        # jnp builds recompiled tiny executables for every new pre-pad
        # shape, even with the bucketed solver cached
        theta_p, t_p, edges_p, _ = pg2.build_graph_np(
            [s.theta_ws for s in self.submaps],
            np.stack([s.t_ws for s in self.submaps]),
            [(l.submap_i, l.submap_j, l.theta_ij, l.t_ij, l.valid)
             for l in self.loops])
        th2, t2, inlier = pg2.optimize_two_phase(theta_p, t_p, edges_p,
                                                 self.opts.pgo)
        th2, t2 = np.asarray(th2)[:m], np.asarray(t2)[:m]
        # write back submap poses and deactivate rejected loops (cpp:243-246)
        n_odo = m - 1
        inl = np.asarray(inlier)[n_odo: n_odo + len(self.loops)]
        for k, l in enumerate(self.loops):
            if not inl[k]:
                self.loops[k] = l._replace(valid=False)
        # current body pose rides its submap (UpdateFramePoseWorld analog)
        cur = self.submaps[-1]
        th_sb, t_sb = cur.world_to_submap(self.theta_wb, self.t_wb)
        for k, s in enumerate(self.submaps):
            old_sm = (s.theta_ws, s.t_ws)
            s.theta_ws = float(th2[k])
            s.t_ws = t2[k]
            # move the seed ring with its submap: recent keyframes are
            # stored at WORLD poses while the reference stores them
            # submap-relative (submap.cpp:14-23) so they ride corrections
            # for free — apply this submap's rigid correction so the next
            # ExpandSubmap seeds from post-correction geometry
            dck = _np_se2_compose(s.theta_ws, s.t_ws,
                                  *_np_se2_inverse(*old_sm))
            s.recent = [
                (xy, v) + (lambda p: (float(p[0]),
                                      np.asarray(p[1], np.float32)))(
                    _np_se2_compose(*dck, th_r, t_r))
                for (xy, v, th_r, t_r) in s.recent]
        old_th, old_t = self.theta_wb, self.t_wb
        th_w, t_w = cur.submap_to_world(th_sb, t_sb)
        self.theta_wb, self.t_wb = float(th_w), np.asarray(t_w, np.float32)
        # apply the same rigid correction to the motion-model memory so the
        # next constant-velocity guess doesn't inherit the PRE-correction
        # frame (a correction-sized guess error right after every optimize)
        dcorr = _np_se2_compose(self.theta_wb, self.t_wb,
                                *_np_se2_inverse(old_th, old_t))
        self.last_theta, self.last_t = (
            lambda p: (p[0], np.asarray(p[1], np.float32)))(
            _np_se2_compose(*dcorr, self.last_theta, self.last_t))
        th_kf, t_kf = _np_se2_compose(*dcorr, self.last_kf_theta,
                                      self.last_kf_t)
        self.last_kf_theta, self.last_kf_t = th_kf, np.asarray(t_kf, np.float32)

    # -- export ---------------------------------------------------------------
    def global_occupancy(self) -> np.ndarray:
        """Stitched global map (ShowGlobalMap analog, mapping_2d.cpp:186-324):
        returns a list of (counts, theta_ws, t_ws) for external rendering."""
        return [(np.asarray(s.grid.counts), s.theta_ws, s.t_ws.copy())
                for s in self.submaps]
