"""Device-resident 2D submap SLAM: the whole per-scan flow as ONE program.

The host-driven `pipeline/mapping2d.Mapping2D` mirrors the reference's
object layer faithfully (Submap/LoopClosing host records, mapping_2d.cpp:
65-130) but pays several device dispatch + sync round trips per keyframe,
which dominate while every kernel is short. This module ports the 3D LIO pattern
(pipeline/lio.py) to 2D:

  * `Mapping2dDeviceState` — fixed-shape device pytree: the CURRENT
    submap's occupancy counts + likelihood field, its SE(2) pose, the
    body pose + motion memory as scalars, and a ring buffer of the last
    `seed_frames` keyframe scans (sensor frame + world pose) for seeding
    the next submap.
  * `step_scan` — one jitted program per scan: constant-velocity guess,
    GN field match, pose update, keyframe test under `lax.cond` with the
    occupancy rasterization + field regeneration inside the branch
    (mapping_2d.cpp:65-130's per-scan flow, fused).
  * The host driver (`Mapping2DDevice`) is reduced to submap lifecycle +
    loop bookkeeping with ONE batched pull per scan: expansion archives
    the device grid into a host `Submap` record (rare) and re-seeds the
    device state from the ring (`expand_state`, one program); loop
    detection / multires re-registration / SE(2) PGO reuse the host-driven
    engine's machinery over the archived submaps unchanged.

Deliberate deviation from the host-driven twin (documented): the seed ring
is GLOBAL (last `seed_frames` keyframes regardless of submap) while the
reference seeds strictly from the previous submap's own frames
(submap.cpp:14-23) — identical whenever the previous submap carried at
least `seed_frames` keyframes, which every practical config does. Parity
vs `Mapping2D` is pinned by tests/test_mapping2d.py.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import grid2d
from ..utils import lie
from .mapping2d import Mapping2D, Mapping2dOptions, Submap, \
    _match_multires_jit


class Mapping2dDeviceState(NamedTuple):
    # current submap
    counts: jax.Array          # (H, W) int32
    touched: jax.Array         # (H, W) bool
    field: jax.Array           # (H, W) float32
    theta_ws: jax.Array        # () submap pose in world
    t_ws: jax.Array            # (2,)
    num_frames: jax.Array      # () int32 keyframes in the current submap
    # global seed ring: last S keyframes (sensor-frame scan + world pose)
    recent_xy: jax.Array       # (S, B, 2)
    recent_valid: jax.Array    # (S, B)
    recent_th: jax.Array       # (S,)
    recent_t: jax.Array        # (S, 2)
    recent_count: jax.Array    # () int32 keyframes ever pushed
    # body pose + motion-model memory
    theta_wb: jax.Array
    t_wb: jax.Array
    last_theta: jax.Array
    last_t: jax.Array
    last_kf_theta: jax.Array
    last_kf_t: jax.Array
    frame_count: jax.Array     # () int32


class StepOut(NamedTuple):
    theta: jax.Array
    t: jax.Array
    is_keyframe: jax.Array
    oob_frac: jax.Array        # expansion trigger (occupancy_map.cpp:137-143)
    num_frames: jax.Array      # submap keyframe count AFTER this scan
    num_effective: jax.Array
    inlier_ratio: jax.Array
    converged: jax.Array


def init_state(opts: Mapping2dOptions, num_beams: int = 720,
               theta_ws: float = 0.0,
               t_ws=np.zeros(2)) -> Mapping2dDeviceState:
    g = grid2d.empty_grid(opts.grid)
    s = opts.seed_frames
    z = jnp.float32(0.0)
    return Mapping2dDeviceState(
        counts=g.counts, touched=g.touched,
        field=grid2d.likelihood_field(g, opts.grid),
        theta_ws=jnp.float32(theta_ws),
        t_ws=jnp.asarray(t_ws, jnp.float32),
        num_frames=jnp.int32(0),
        recent_xy=jnp.zeros((s, num_beams, 2), jnp.float32),
        recent_valid=jnp.zeros((s, num_beams), bool),
        recent_th=jnp.zeros((s,), jnp.float32),
        recent_t=jnp.zeros((s, 2), jnp.float32),
        recent_count=jnp.int32(0),
        theta_wb=z, t_wb=jnp.zeros(2, jnp.float32),
        last_theta=z, last_t=jnp.zeros(2, jnp.float32),
        last_kf_theta=z, last_kf_t=jnp.zeros(2, jnp.float32),
        frame_count=jnp.int32(0))


@functools.partial(jax.jit, static_argnames=("opts",))
def step_scan(state: Mapping2dDeviceState, scan_xy: jax.Array,
              valid: jax.Array, opts: Mapping2dOptions):
    """ProcessScan (mapping_2d.cpp:65-130) as one XLA program: guess,
    match, pose update, keyframe raster + field regen under lax.cond."""
    first = state.frame_count == 0
    guess_th = state.theta_wb + lie.wrap_angle(state.theta_wb
                                               - state.last_theta)
    guess_t = state.t_wb + (state.t_wb - state.last_t)

    inv_th, inv_t = lie.se2_inverse(state.theta_ws, state.t_ws)
    th0, t0 = lie.se2_compose(inv_th, inv_t, guess_th, guess_t)
    res = grid2d.align_gauss_newton(state.field, opts.grid, scan_xy, valid,
                                    th0, t0, opts.align)
    th_w, t_w = lie.se2_compose(state.theta_ws, state.t_ws, res.theta, res.t)
    th_w = jnp.where(first, state.theta_wb, lie.wrap_angle(th_w))
    t_w = jnp.where(first, state.t_wb, t_w)

    d = jnp.linalg.norm(t_w - state.last_kf_t)
    a = jnp.abs(lie.wrap_angle(th_w - state.last_kf_theta))
    is_kf = first | (d > opts.keyframe_dist) | (
        a > jnp.deg2rad(opts.keyframe_angle_deg))

    state = state._replace(
        last_theta=state.theta_wb, last_t=state.t_wb,
        theta_wb=th_w, t_wb=t_w, frame_count=state.frame_count + 1)

    def on_kf(st: Mapping2dDeviceState) -> Mapping2dDeviceState:
        ith, it = lie.se2_inverse(st.theta_ws, st.t_ws)
        th_sb, t_sb = lie.se2_compose(ith, it, th_w, t_w)
        pts = lie.se2_apply(th_sb, t_sb, scan_xy)
        grid = grid2d.OccupancyGrid(counts=st.counts, touched=st.touched)
        grid2, field2 = grid2d.add_scan_and_field(grid, opts.grid, pts,
                                                  valid, t_sb)
        slot = jnp.mod(st.recent_count, st.recent_xy.shape[0])
        upd = lambda buf, row: jax.lax.dynamic_update_index_in_dim(
            buf, row, slot, 0)
        return st._replace(
            counts=grid2.counts, touched=grid2.touched, field=field2,
            num_frames=st.num_frames + 1,
            recent_xy=upd(st.recent_xy, scan_xy),
            recent_valid=upd(st.recent_valid, valid),
            recent_th=upd(st.recent_th, th_w),
            recent_t=upd(st.recent_t, t_w),
            recent_count=st.recent_count + 1,
            last_kf_theta=th_w, last_kf_t=t_w)

    state = jax.lax.cond(is_kf, on_kf, lambda s: s, state)

    # expansion trigger geometry (the host decides; occupancy_map.cpp:137-143)
    ith, it = lie.se2_inverse(state.theta_ws, state.t_ws)
    th_sb, t_sb = lie.se2_compose(ith, it, th_w, t_w)
    oob = grid2d.out_of_bounds_fraction(
        opts.grid, lie.se2_apply(th_sb, t_sb, scan_xy), valid)

    return state, StepOut(theta=th_w, t=t_w, is_keyframe=is_kf,
                          oob_frac=oob, num_frames=state.num_frames,
                          num_effective=res.num_effective,
                          inlier_ratio=res.inlier_ratio,
                          converged=res.converged)


@functools.partial(jax.jit, static_argnames=("opts",))
def expand_state(state: Mapping2dDeviceState,
                 opts: Mapping2dOptions) -> Mapping2dDeviceState:
    """ExpandSubmap on the device state (mapping_2d.cpp:154-184 +
    SetOccuFromOtherSubmap, submap.cpp:14-23): fresh grid at the CURRENT
    body pose, seeded by rasterizing the ring's keyframes (re-expressed in
    the new frame) + the current scan at the new-frame origin, ONE field
    regen. The caller archives the old grid before this."""
    s = state.recent_xy.shape[0]
    th_new, t_new = state.theta_wb, state.t_wb
    inv_th, inv_t = lie.se2_inverse(th_new, t_new)
    count = jnp.minimum(state.recent_count, s)

    # chronological ring order: oldest first
    idx = jnp.mod(state.recent_count - count + jnp.arange(s), s)
    r_xy = state.recent_xy[idx]
    r_valid = state.recent_valid[idx]
    r_th = state.recent_th[idx]
    r_t = state.recent_t[idx]
    th_sb, t_sb = lie.se2_compose(inv_th, inv_t, r_th, r_t)    # (S,), (S,2)
    pts = lie.se2_apply(th_sb, t_sb, r_xy)                     # (S, B, 2)

    g0 = grid2d.empty_grid(opts.grid)
    grid, _ = grid2d.add_scans_and_field(g0, opts.grid, pts, r_valid,
                                         t_sb, count)
    # the current scan again at (0, 0) exactly (new.add_scan after seeding,
    # mapping_2d.cpp:164-172) — it is the newest ring entry
    newest = jnp.mod(state.recent_count - 1, s)
    grid, field = grid2d.add_scan_and_field(
        grid, opts.grid, state.recent_xy[newest],
        state.recent_valid[newest], jnp.zeros(2, jnp.float32))
    return state._replace(
        counts=grid.counts, touched=grid.touched, field=field,
        theta_ws=th_new, t_ws=t_new, num_frames=jnp.int32(1))


@jax.jit
def _corrected_ring(recent_th, recent_t, old_th, old_t, new_th, new_t):
    """Apply the body-pose rigid correction dcorr = T_new T_old^-1 to the
    seed ring's world poses (one program; module-level jit per CLAUDE.md's
    recompile rule). No-op when the correction is identity."""
    ith, it = lie.se2_inverse(old_th, old_t)
    cth, ct = lie.se2_compose(new_th, new_t, ith, it)
    moved = (jnp.abs(lie.wrap_angle(cth)) > 1e-9) | (
        jnp.linalg.norm(ct) > 1e-9)
    th2, t2 = lie.se2_compose(cth, ct, recent_th, recent_t)
    th2 = lie.wrap_angle(th2)
    return (jnp.where(moved, th2, recent_th),
            jnp.where(moved, t2, recent_t))


class Mapping2DDevice(Mapping2D):
    """Device-resident drop-in for `Mapping2D`: same public surface
    (process_scan / submaps / loops / optimize / global_occupancy), one
    batched pull per scan. Loop detection, multires re-registration, the
    SE(2) pose graph and its write-back run unchanged on the ARCHIVED host
    submaps; the write-back additionally pushes the corrected poses into
    the device state."""

    def __init__(self, opts: Mapping2dOptions = Mapping2dOptions(),
                 num_beams: int = 720, warm_start: bool = True,
                 pipelined: bool = False):
        super().__init__(opts)
        self.dstate = init_state(opts, num_beams=num_beams)
        # lag-1 pipelining (see _process_scan_pipelined): poses return one
        # scan late, call flush() at end; exact via replay-on-mutation
        self.pipelined = pipelined
        self._pend = None
        self.replays = 0       # lifecycle replays performed (observable)
        # Warm the LOOP-CLOSURE executables ahead of the first attempt (the
        # 2D analog of slam3d.warm_solver): the multires pyramid match and
        # the SE(2) PGO compile/cache-load are each a long compile, and
        # without warming they land exactly at the first loop candidate as
        # a stall of the host loop.
        self._warm_thread = None
        if warm_start:
            # non-daemon ON PURPOSE: a daemon thread cancelled mid-XLA at
            # interpreter exit aborts the process ("FATAL: exception not
            # rethrown"); a clean exit instead waits for the compile
            self._warm_thread = threading.Thread(
                target=self._warm_loop_programs, name="m2d-warm")
            self._warm_thread.start()

    def _warm_loop_programs(self) -> None:
        try:
            from ..graph import pose_graph2d as pg2

            b = self.dstate.recent_xy.shape[1]
            res = _match_multires_jit(
                self.dstate.field, self.opts.grid, self.opts.align,
                self.opts.pyramid_factors,
                jnp.zeros((b, 2), jnp.float32), jnp.zeros((b,), bool),
                jnp.float32(0.0), jnp.zeros(2, jnp.float32))
            jax.block_until_ready(res.theta)
            if self.opts.lm_fallback:
                # the LM retry executable would otherwise compile at the
                # first FAILED loop candidate (a compile stall)
                import dataclasses as _dc

                res = _match_multires_jit(
                    self.dstate.field, self.opts.grid,
                    _dc.replace(self.opts.align, method="lm"),
                    self.opts.pyramid_factors,
                    jnp.zeros((b, 2), jnp.float32), jnp.zeros((b,), bool),
                    jnp.float32(0.0), jnp.zeros(2, jnp.float32))
                jax.block_until_ready(res.theta)
            # the EXACT solver shape build_graph_np produces for any
            # session up to 32 submaps / 64 edges (its minimum buckets)
            th_p, t_p, e_p, _ = pg2.build_graph_np(
                np.zeros(2, np.float32), np.zeros((2, 2), np.float32),
                [(0, 1, 0.0, np.zeros(2, np.float32), True)])
            out = pg2.optimize_two_phase(th_p, t_p, e_p, self.opts.pgo)
            jax.block_until_ready(out[0])
        except Exception:               # warm-up is best-effort
            pass

    # -- per-scan -----------------------------------------------------------
    def process_scan(self, scan_xy: np.ndarray, valid: np.ndarray):
        if self.pipelined:
            return self._process_scan_pipelined(scan_xy, valid)
        self.dstate, out = step_scan(self.dstate, jnp.asarray(scan_xy),
                                     jnp.asarray(valid), self.opts)
        # ONE batched pull per scan (a round trip per transfer)
        self._apply_result(scan_xy, valid, out)
        return self.theta_wb, self.t_wb.copy()

    def _apply_result(self, scan_xy, valid, out: StepOut) -> bool:
        """Pull one StepOut and run the host-side mirror updates + submap
        lifecycle + loop detection. Returns True when the DEVICE state was
        mutated by the lifecycle (submap expansion, or a loop-closure
        optimize write-back) — the signal the pipelined mode uses to
        replay an in-flight scan."""
        th, t, is_kf, oob, nfr = jax.device_get(
            (out.theta, out.t, out.is_keyframe, out.oob_frac,
             out.num_frames))
        state_at_entry = self.dstate
        # host mirrors evolve by the same update rules as the device state
        self.last_theta, self.last_t = self.theta_wb, self.t_wb
        self.theta_wb, self.t_wb = float(th), np.asarray(t, np.float32)
        self.frame_poses.append((self.theta_wb, self.t_wb.copy()))

        if bool(is_kf):
            self.last_kf_theta, self.last_kf_t = self.theta_wb, self.t_wb
            cur = self.submaps[-1]
            cur.num_frames = int(nfr)
            cur.frame_ids.append(self.frame_count)
            if float(oob) > 0.1 or int(nfr) > self.opts.max_keyframes_in_submap:
                self._expand_device()
            self._detect_loops(scan_xy, valid)
        self.frame_count += 1
        return self.dstate is not state_at_entry

    def _process_scan_pipelined(self, scan_xy, valid):
        """Lag-1 pipelined per-scan flow (the sequential loop pays
        dispatch+sync THEN a result pull per scan; here
        scan k's device step runs WHILE the host pulls and handles scan
        k-1's result, hiding the pull entirely). EXACT, not approximate:
        when handling k-1 mutates the device state (submap expansion /
        loop write-back — rare), the in-flight scan k was dispatched
        against a stale state and is REPLAYED from the corrected one, so
        the state chain is identical to sequential mode
        (tests/test_mapping2d.py pins trajectory equality).

        Returns the PREVIOUS scan's pose (None on the first call); call
        `flush()` after the last scan for the final pose."""
        state_before = self.dstate
        self.dstate, out = step_scan(self.dstate, jnp.asarray(scan_xy),
                                     jnp.asarray(valid), self.opts)
        cur = {"xy": scan_xy, "valid": valid, "out": out,
               "state_before": state_before}
        res = None
        if self._pend is not None:
            res = self._finish_pending(cur)
        self._pend = cur
        return res

    def _finish_pending(self, cur):
        """Handle the pending scan's result; replay `cur`'s dispatch if the
        lifecycle mutated the device state. Returns the pending pose."""
        p = self._pend
        post_cur_state = self.dstate
        # host logic must see the state as of AFTER the pending scan —
        # which is exactly the state `cur` was dispatched from (or the
        # current state at flush time)
        self.dstate = cur["state_before"] if cur is not None else self.dstate
        mutated = self._apply_result(p["xy"], p["valid"], p["out"])
        if cur is not None:
            if mutated:
                # the in-flight dispatch is stale: replay from the
                # corrected state (rare: expansions + accepted loops)
                self.replays += 1
                cur["state_before"] = self.dstate
                self.dstate, cur["out"] = step_scan(
                    self.dstate, jnp.asarray(cur["xy"]),
                    jnp.asarray(cur["valid"]), self.opts)
            else:
                self.dstate = post_cur_state
        return self.theta_wb, self.t_wb.copy()

    def flush(self):
        """Drain the pipelined tail: handle the last in-flight scan.
        No-op in sequential mode."""
        if self._pend is None:
            return self.theta_wb, self.t_wb.copy()
        res = self._finish_pending(None)
        self._pend = None
        return res

    # -- submap lifecycle ---------------------------------------------------
    def _expand_device(self) -> None:
        """Archive the device grid into the current host Submap record, then
        re-seed the device state as the new submap (ExpandSubmap analog).

        ZERO-COPY archive: jax arrays are immutable, so the current device
        buffers simply BECOME the archived submap's grid/field — expand_state
        produces fresh arrays for the new submap and nothing crosses the
        wire (an eager pull per expansion otherwise).
        Archived submaps keep ~9 MB of HBM each; loop re-registration reads
        the field in place, exports pull counts once at artifact time."""
        cur = self.submaps[-1]
        cur.grid = grid2d.OccupancyGrid(counts=self.dstate.counts,
                                        touched=self.dstate.touched)
        cur.field = self.dstate.field
        new = Submap(self.opts, self.theta_wb, self.t_wb, len(self.submaps))
        new.num_frames = 1
        self.submaps.append(new)
        self.dstate = expand_state(self.dstate, self.opts)
        jax.block_until_ready(self.dstate.field)
        # bounded HBM: beyond the device budget the OLDEST archives spill
        # to host numpy (one pull each; re-uploaded transparently if a loop
        # candidate ever matches them again) — a long run would otherwise
        # pin ~9 MB of HBM per submap forever
        budget = self.opts.archived_device_submaps
        # budget=0 means "keep NO archives in HBM": spill every archived
        # submap (the `[:-0]` slice would keep them all — advisor round 4)
        spill = self.submaps[:-1][:-budget] if budget > 0 else self.submaps[:-1]
        for sm in spill:
            if isinstance(sm.field, jax.Array):
                sm.grid = grid2d.OccupancyGrid(
                    counts=np.asarray(sm.grid.counts),
                    touched=np.asarray(sm.grid.touched))
                sm.field = np.asarray(sm.field)

    # -- pose-graph write-back ----------------------------------------------
    def optimize(self):
        old_th, old_t = self.theta_wb, np.asarray(self.t_wb, np.float32)
        super().optimize()
        # push the corrected poses into the device state (the host-driven
        # optimize updated the proxy submap + the pose mirrors)
        cur = self.submaps[-1]
        self.dstate = self.dstate._replace(
            theta_ws=jnp.float32(cur.theta_ws),
            t_ws=jnp.asarray(cur.t_ws, jnp.float32),
            theta_wb=jnp.float32(self.theta_wb),
            t_wb=jnp.asarray(self.t_wb, jnp.float32),
            last_theta=jnp.float32(self.last_theta),
            last_t=jnp.asarray(self.last_t, jnp.float32),
            last_kf_theta=jnp.float32(self.last_kf_theta),
            last_kf_t=jnp.asarray(self.last_kf_t, jnp.float32))
        # move the seed ring's world poses with the correction too — else
        # the first expand_state after a PGO re-expresses ring keyframes
        # with stale pre-correction poses, misaligning the new submap's
        # seed raster by the correction delta (advisor round 4).
        # APPROXIMATION: the ring is global (last S keyframes across
        # submaps) so every entry rides the CURRENT submap's rigid
        # correction — exact for ring entries of the current submap (the
        # common case: the ring holds the newest keyframes), off by the
        # inter-submap correction difference for older ones; the host twin
        # applies per-submap corrections to each Submap.recent.
        new_th, new_t = _corrected_ring(
            self.dstate.recent_th, self.dstate.recent_t,
            jnp.float32(old_th), jnp.asarray(old_t, jnp.float32),
            jnp.float32(self.theta_wb), jnp.asarray(self.t_wb, jnp.float32))
        self.dstate = self.dstate._replace(recent_th=new_th, recent_t=new_t)

    # -- export --------------------------------------------------------------
    def global_occupancy(self):
        out = [(np.asarray(s.grid.counts), s.theta_ws, s.t_ws.copy())
               for s in self.submaps[:-1]]
        out.append((np.asarray(self.dstate.counts),
                    float(self.dstate.theta_ws),
                    np.asarray(self.dstate.t_ws)))
        return out
