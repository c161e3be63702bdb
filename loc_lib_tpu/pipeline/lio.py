"""LIO: keyframe LiDAR(-inertial) odometry and local mapping.

Rebuild of the reference `class Lio`
(/root/reference/LocUtils/src/slam/3d/lio.cpp, include .../slam/3d/lio.hpp).
The C++ object with heap-allocated PCL keyframe clouds becomes a pure
`(LioState, scan) -> (LioState, StepResult)` function over fixed-shape
tensors, so the WHOLE per-scan pipeline — voxel filter, constant-velocity /
ESKF prediction, Gauss-Newton scan match, ESKF fusion, keyframe decision,
ring-buffer local-map rebuild, hash-grid/NDT target refresh — is one XLA
program. Data-dependent decisions (is-keyframe) run under `lax.cond` on
device; there is no host round-trip inside the step.

Mapping of reference structure -> this module:
  * Lio::AddCloud (lio.cpp:219-308)           -> `step` / `_add_cloud`
  * Lio::AddMeasure (lio.cpp:412-444)         -> `step_measure`
  * AlignWithLocalMap (lio.cpp:446-473)       -> `_align` (+ const-velocity
    prediction `predict = result * last^-1 * result`, lio.cpp:455-459)
  * IsKeyframe (lio.cpp:616-623)              -> `_is_keyframe`
  * sliding window of num_kfs_in_local_map=10 keyframe clouds rebuilt and
    voxel-filtered per keyframe (lio.cpp:267-307) -> ring buffer of padded
    keyframe tensors + one fused transform/concat/downsample/grid build
  * LOAM variant with separate edge/surf maps (lio.cpp:311-410)
    -> matcher="loam" with twin ring buffers
  * incremental NDT gets only the new keyframe (lio.cpp:291-296)
    -> matcher="ndt_inc" path calling ndt.update_incremental
  * Lio::InitImu (lio.cpp:70-99)              -> `Lio.init_imu` host driver

Keyframe clouds are stored in the LIDAR frame and re-transformed by their
(possibly updated) world poses at every rebuild — same dataflow as the
reference, which re-loads keyframe PCDs and transforms by `estimated_poses_`
(lio.cpp:550-580), but kept resident in device HBM instead of on disk.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pointcloud import PointCloud, PAD_COORD
from ..ops import voxel as voxel_ops
from ..models import icp, ndt, loam, eskf as eskf_mod
from ..utils import lie


@dataclasses.dataclass(frozen=True)
class LioOptions:
    """Mirror of LioOptions (lio.hpp:31-51) + static shape knobs."""

    matcher: str = "icp"              # icp | icp_vox_inc | ndt | ndt_inc | loam
    icp: icp.IcpOptions = icp.IcpOptions()
    ndt: ndt.NdtOptions = ndt.NdtOptions()
    loam: loam.LoamOption = loam.LoamOption()
    kf_distance: float = 0.5          # keyframe translation gate (m)
    kf_angle_deg: float = 30.0        # keyframe rotation gate (deg)
    num_kfs_in_local_map: int = 10
    scan_filter_leaf: float = 1.0     # cur_scan_filter_size
    map_filter_leaf: float = 0.5      # local_map_filter_size
    scan_capacity: int = 8192         # padded points per filtered scan
    imu_capacity: int = 64            # padded IMU samples per measure group
    with_eskf: bool = True
    # matcher="icp_vox_inc": every Nth accepted keyframe, REBUILD the moment
    # table from the keyframe ring-buffer window at the CURRENT (corrected)
    # poses instead of absorbing only the new scan — bounds how much odometry
    # drift bakes into the map (the accuracy gap vs the batch path, see
    # `inc_ndt` note) while paying the full-window re-sort only 1/N of the
    # time. 0 disables rebuilds (pure absorption; note absorption always
    # uses the voxel-DOWNSAMPLED scan — a documented, measured deviation
    # from the reference, which feeds the raw keyframe to its incremental
    # NDT, lio.cpp:299).
    vox_inc_reanchor: int = 5

    # Static row budget of the assembled local map as a fraction of the
    # window's raw capacity (num_kfs * scan_capacity). After the 0.5 m
    # voxel downsample the live points are ~40% of the padded rows, yet
    # every keyframe-rebuild stage (voxel stats, neighbor merge, eigh,
    # hash grid, dense scatter) costs by PADDED shape — compacting the
    # downsampled window to this budget cuts the rebuild roughly in
    # proportion. Overflow is counted in LioState.map_overflow
    # (observable, never silent). 1.0 disables compaction.
    local_map_budget_factor: float = 0.625

    @property
    def local_map_capacity(self) -> int:
        return self.num_kfs_in_local_map * self.scan_capacity

    @property
    def local_map_budget(self) -> int:
        cap = self.local_map_capacity
        b = int(cap * self.local_map_budget_factor)
        return min(cap, max(1024, -(-b // 1024) * 1024))

    @property
    def inc_ndt(self) -> ndt.NdtOptions:
        """Moment-table options backing matcher='icp_vox_inc': floor-binned
        incremental voxel Gaussians at the ICP grid leaf, from which the
        plane table is re-derived per keyframe (O(voxels), no local-map
        re-sort). Age eviction replaces the sliding
        keyframe window for map forgetting.

        Accuracy trade-off (measured on the full demo log):
        like the reference's incremental NDT (and matcher='ndt_inc' here),
        points are absorbed at their ABSORPTION-TIME world poses, so
        odometry drift bakes into the map — the batch rebuild (matcher=
        'icp' + p2plane_vox) re-transforms keyframes by their current poses
        each window and tracks tighter on long runs. Prefer 'icp' +
        p2plane_vox unless the rebuild cost dominates."""
        return dataclasses.replace(
            self.ndt, method="incremental", voxel_size=self.icp.grid_leaf,
            bin_mode="floor", dense_dims=self.icp.dense_dims)


class LioState(NamedTuple):
    """Everything the per-scan step needs, as one device-resident pytree."""

    # Current / previous lidar pose in world (for const-velocity prediction).
    R: jax.Array                 # (3, 3)
    t: jax.Array                 # (3,)
    last_R: jax.Array
    last_t: jax.Array
    # Keyframe ring buffer (lidar-frame clouds + world poses).
    kf_xyz: jax.Array            # (K, N, 3)
    kf_mask: jax.Array           # (K, N)
    kf_R: jax.Array              # (K, 3, 3)
    kf_t: jax.Array              # (K, 3)
    last_kf_R: jax.Array         # pose of the most recent keyframe
    last_kf_t: jax.Array
    num_kfs: jax.Array           # () int32 total keyframes ever accepted
    # Matcher target (exactly one is live depending on opts.matcher).
    icp_target: Optional[icp.IcpTarget]
    ndt_map: Optional[ndt.NdtMap]
    loam_target: Optional[loam.LoamTarget]
    # LOAM twin ring buffer (edge features; kf_* holds surf when matcher=loam).
    kf_edge_xyz: Optional[jax.Array]
    kf_edge_mask: Optional[jax.Array]
    # Error-state KF (IMU fusion); identity-propagated when with_eskf=False.
    eskf: eskf_mod.EskfState
    # T_imu_lidar extrinsic (lio.cpp:58-68).
    R_il: jax.Array
    t_il: jax.Array
    frame_idx: jax.Array         # () int32
    # points dropped at the last local-map compaction (observable)
    map_overflow: jax.Array      # () int32


class StepResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    is_keyframe: jax.Array
    converged: jax.Array
    num_effective: jax.Array
    iterations: jax.Array
    chi2: jax.Array


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------

def init_state(opts: LioOptions, R_il=None, t_il=None) -> LioState:
    k, n = opts.num_kfs_in_local_map, opts.scan_capacity
    eye = jnp.eye(3, dtype=jnp.float32)
    z3 = jnp.zeros((3,), jnp.float32)
    is_loam = opts.matcher == "loam"
    pad_kf = jnp.full((k, n, 3), PAD_COORD, jnp.float32)
    state = LioState(
        R=eye, t=z3, last_R=eye, last_t=z3,
        kf_xyz=pad_kf,
        kf_mask=jnp.zeros((k, n), bool),
        kf_R=jnp.broadcast_to(eye, (k, 3, 3)),
        kf_t=jnp.zeros((k, 3), jnp.float32),
        last_kf_R=eye, last_kf_t=z3,
        num_kfs=jnp.int32(0),
        icp_target=None, ndt_map=None, loam_target=None,
        kf_edge_xyz=pad_kf if is_loam else None,
        kf_edge_mask=jnp.zeros((k, n), bool) if is_loam else None,
        eskf=eskf_mod.init_state(),
        R_il=eye if R_il is None else jnp.asarray(R_il, jnp.float32),
        t_il=z3 if t_il is None else jnp.asarray(t_il, jnp.float32),
        frame_idx=jnp.int32(0),
        map_overflow=jnp.int32(0),
    )
    # Pre-size the matcher target with an empty cloud so the pytree structure
    # is fixed from step 0.
    empty = _empty_map_cloud(opts)
    if opts.matcher in ("icp",):
        state = state._replace(icp_target=icp.set_target(empty, opts.icp))
    elif opts.matcher == "icp_vox_inc":
        assert opts.icp.method == "p2plane_vox", opts.icp.method
        m0 = ndt.empty_incremental(opts.inc_ndt)
        state = state._replace(
            ndt_map=m0, icp_target=_derive_vox_target(opts, m0))
    elif opts.matcher == "ndt":
        state = state._replace(ndt_map=ndt.build_direct(empty, opts.ndt))
    elif opts.matcher == "ndt_inc":
        inc = dataclasses.replace(opts.ndt, method="incremental")
        state = state._replace(ndt_map=ndt.empty_incremental(inc))
    elif opts.matcher == "loam":
        state = state._replace(
            loam_target=loam.set_target(empty, empty, opts.loam))
    else:
        raise ValueError(f"unknown matcher {opts.matcher!r}")
    return state


def _derive_vox_target(opts: LioOptions, m: ndt.NdtMap) -> icp.IcpTarget:
    return icp.target_from_moment_table(
        m.keys, m.count, m.mean, m.cov, m.dense_table, m.dense_lo,
        m.origin, opts.icp, opts.icp.dense_dims)


def _empty_map_cloud(opts: LioOptions) -> PointCloud:
    # budget-sized: must match the shapes _assemble_local_map produces so
    # the keyframe lax.cond branches carry identical target pytrees
    m = opts.local_map_budget
    return PointCloud(xyz=jnp.full((m, 3), PAD_COORD, jnp.float32),
                      mask=jnp.zeros((m,), bool))


# ---------------------------------------------------------------------------
# Pieces of the step
# ---------------------------------------------------------------------------

def _is_keyframe(opts: LioOptions, state: LioState, R, t) -> jax.Array:
    """IsKeyframe (lio.cpp:616-623): relative motion vs the last keyframe."""
    dR, dt = lie.se3_compose(*lie.se3_inverse(state.last_kf_R, state.last_kf_t), R, t)
    ang = jnp.linalg.norm(lie.so3_log(dR))
    first = state.num_kfs == 0
    return first | (jnp.linalg.norm(dt) > opts.kf_distance) | (
        ang > jnp.deg2rad(opts.kf_angle_deg))


def _assemble_local_map(opts: LioOptions, kf_xyz, kf_mask, kf_R, kf_t):
    """Transform the keyframe window to world, concat, voxel-filter
    (lio.cpp:282-297) as one fused program, then compact the survivors to
    the static local_map_budget rows so every downstream rebuild stage
    runs at the LIVE point scale, not the padded window scale.
    Returns (cloud, origin, overflow)."""
    k, n, _ = kf_xyz.shape
    world = jnp.einsum("kij,knj->kni", kf_R, kf_xyz) + kf_t[:, None, :]
    world = jnp.where(kf_mask[..., None], world, PAD_COORD)
    merged = PointCloud(xyz=world.reshape(k * n, 3), mask=kf_mask.reshape(k * n))
    # Re-center the voxel key window on the current map so long trajectories
    # never walk out of the +-512-cell key range.
    origin = jnp.sum(kf_t, axis=0) / jnp.maximum(
        jnp.sum((jnp.sum(kf_mask, axis=1) > 0).astype(jnp.float32)), 1.0)
    ds = voxel_ops.voxel_downsample(merged, opts.map_filter_leaf, origin=origin)
    budget = opts.local_map_budget
    if budget >= ds.capacity:
        return ds, origin, jnp.int32(0)
    order = jnp.argsort(~ds.mask, stable=True)[:budget]
    mask = ds.mask[order]
    xyz = jnp.where(mask[:, None], ds.xyz[order], PAD_COORD)
    overflow = jnp.maximum(
        jnp.sum(ds.mask.astype(jnp.int32)) - budget, 0)
    return PointCloud(xyz=xyz, mask=mask), origin, overflow


def _push_keyframe(opts, state: LioState, scan_xyz, scan_mask, R, t,
                   edge_xyz=None, edge_mask=None) -> LioState:
    """Insert (scan, pose) into the ring buffer and rebuild the matcher
    target (lio.cpp:267-307)."""
    k = opts.num_kfs_in_local_map
    slot = jnp.mod(state.num_kfs, k)
    upd = lambda buf, row: jax.lax.dynamic_update_index_in_dim(buf, row, slot, 0)
    kf_xyz = upd(state.kf_xyz, scan_xyz)
    kf_mask = upd(state.kf_mask, scan_mask)
    kf_R = upd(state.kf_R, R)
    kf_t = upd(state.kf_t, t)
    new = state._replace(
        kf_xyz=kf_xyz, kf_mask=kf_mask, kf_R=kf_R, kf_t=kf_t,
        last_kf_R=R, last_kf_t=t, num_kfs=state.num_kfs + 1,
    )
    if opts.matcher == "icp":
        local_map, origin, ovf = _assemble_local_map(opts, kf_xyz, kf_mask,
                                                     kf_R, kf_t)
        new = new._replace(icp_target=icp.set_target(local_map, opts.icp, origin),
                           map_overflow=ovf)
    elif opts.matcher == "icp_vox_inc":
        # absorb only the NEW keyframe into the moment table, then re-derive
        # the plane table in O(voxels) — no local-map re-sort. Every
        # `vox_inc_reanchor`-th keyframe the table is instead rebuilt from
        # the ring-buffer window at the current poses, flushing baked-in
        # drift (the documented ATE gap of pure absorption).
        world = scan_xyz @ R.T + t
        world = jnp.where(scan_mask[:, None], world, PAD_COORD)
        # Absorb the keyframe DOWNSAMPLED at the local-map leaf, exactly
        # what the batch path feeds set_target (lio.cpp:282-297): raw scans
        # overweight the dense near-field and skew the voxel Gaussians
        # (measured: raw absorption tracks ~2x worse than the batch path on
        # the demo log even before any drift accumulates).
        scan_w = voxel_ops.voxel_downsample(
            PointCloud(xyz=world, mask=scan_mask), opts.map_filter_leaf,
            origin=t)

        def absorb(m):
            return ndt.update_incremental(m, scan_w, opts.inc_ndt)

        if opts.vox_inc_reanchor > 0:
            def reanchor(m):
                # downsampled window — consistent count scale with absorb.
                # Re-center the +-512-cell voxel key window on the window's
                # returned origin (origin is data, so both lax.cond branch
                # structures still match): anchoring at the ORIGINAL origin
                # silently INVALID_KEY-drops points once the trajectory
                # leaves the initial window (ADVICE r2).
                local_map, origin, _ = _assemble_local_map(
                    opts, kf_xyz, kf_mask, kf_R, kf_t)
                m0 = ndt.empty_incremental(opts.inc_ndt, origin=origin)
                return ndt.update_incremental(m0, local_map, opts.inc_ndt)

            do_re = jnp.mod(new.num_kfs, opts.vox_inc_reanchor) == 0
            m2 = jax.lax.cond(do_re, reanchor, absorb, new.ndt_map)
        else:
            m2 = absorb(new.ndt_map)
        new = new._replace(ndt_map=m2,
                           icp_target=_derive_vox_target(opts, m2))
    elif opts.matcher == "ndt":
        local_map, origin, ovf = _assemble_local_map(opts, kf_xyz, kf_mask,
                                                     kf_R, kf_t)
        new = new._replace(ndt_map=ndt.build_direct(local_map, opts.ndt, origin),
                           map_overflow=ovf)
    elif opts.matcher == "ndt_inc":
        # incremental NDT absorbs only the new keyframe (lio.cpp:291-296)
        inc = dataclasses.replace(opts.ndt, method="incremental")
        world = scan_xyz @ R.T + t
        world = jnp.where(scan_mask[:, None], world, PAD_COORD)
        new = new._replace(ndt_map=ndt.update_incremental(
            new.ndt_map, PointCloud(xyz=world, mask=scan_mask), inc))
    elif opts.matcher == "loam":
        kf_edge_xyz = upd(state.kf_edge_xyz, edge_xyz)
        kf_edge_mask = upd(state.kf_edge_mask, edge_mask)
        new = new._replace(kf_edge_xyz=kf_edge_xyz, kf_edge_mask=kf_edge_mask)
        surf_map, origin, ovf_s = _assemble_local_map(opts, kf_xyz, kf_mask,
                                                       kf_R, kf_t)
        edge_map, _, ovf_e = _assemble_local_map(opts, kf_edge_xyz,
                                                 kf_edge_mask, kf_R, kf_t)
        new = new._replace(loam_target=loam.set_target(
            edge_map, surf_map, opts.loam, origin),
            map_overflow=ovf_s + ovf_e)
    return new


def _align(opts: LioOptions, state: LioState, src: PointCloud, R0, t0,
           edge_src: Optional[PointCloud] = None):
    if opts.matcher in ("icp", "icp_vox_inc"):
        return icp.scan_match(state.icp_target, opts.icp, src, R0, t0)
    if opts.matcher == "ndt":
        return ndt.scan_match(state.ndt_map, opts.ndt, src, R0, t0)
    if opts.matcher == "ndt_inc":
        inc = dataclasses.replace(opts.ndt, method="incremental")
        return ndt.scan_match(state.ndt_map, inc, src, R0, t0)
    if opts.matcher == "loam":
        return loam.scan_match(state.loam_target, opts.loam, edge_src, src, R0, t0)
    raise ValueError(opts.matcher)


def _predict_pose(opts: LioOptions, state: LioState):
    """Motion prediction for the matcher.

    ESKF path: T_w_l = T_w_i * T_i_l from the filter nominal (lio.cpp:452).
    Pure-lidar path: constant velocity, predict = cur * last^-1 * cur
    (lio.cpp:455-459).
    """
    if opts.with_eskf:
        Ri, ti = eskf_mod.nominal_se3(state.eskf)
        return lie.se3_compose(Ri, ti, state.R_il, state.t_il)
    dR, dt = lie.se3_compose(state.R, state.t, *lie.se3_inverse(state.last_R, state.last_t))
    return lie.se3_compose(dR, dt, state.R, state.t)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("opts",))
def step(state: LioState, scan: PointCloud, opts: LioOptions,
         edge_scan: Optional[PointCloud] = None):
    """Lio::AddCloud (lio.cpp:219-308): one scan in, updated state + pose out.

    `scan` must already be voxel-filtered to `opts.scan_capacity` (use
    `preprocess_scan`); for matcher="loam" pass the surf features as `scan`
    and the edge features as `edge_scan`.
    """
    first = state.frame_idx == 0
    R0, t0 = _predict_pose(opts, state)
    # First scan: identity pose, no matching (lio.cpp:224-233).
    R0 = jnp.where(first, jnp.eye(3, dtype=jnp.float32), R0)
    t0 = jnp.where(first, jnp.zeros(3, jnp.float32), t0)

    res = _align(opts, state, scan, R0, t0, edge_src=edge_scan)
    R_new = jnp.where(first, R0, res.R)
    t_new = jnp.where(first, t0, res.t)

    # ESKF fusion: observe the matched LIDAR pose as an IMU-frame pose
    # observation, then take the nominal back (lio.cpp:260-265).
    if opts.with_eskf:
        Ril_inv, til_inv = lie.se3_inverse(state.R_il, state.t_il)
        R_imu, t_imu = lie.se3_compose(R_new, t_new, Ril_inv, til_inv)
        new_eskf = eskf_mod.observe_se3(state.eskf, R_imu, t_imu, eskf_mod.EskfOptions())
        skip = first  # no observation before the map exists
        new_eskf = jax.tree_util.tree_map(
            lambda a, b: jnp.where(skip, b, a), new_eskf, state.eskf)
        Ri, ti = eskf_mod.nominal_se3(new_eskf)
        R_fused, t_fused = lie.se3_compose(Ri, ti, state.R_il, state.t_il)
        R_new = jnp.where(first, R_new, R_fused)
        t_new = jnp.where(first, t_new, t_fused)
    else:
        new_eskf = state.eskf

    state = state._replace(last_R=state.R, last_t=state.t,
                           R=R_new, t=t_new, eskf=new_eskf,
                           frame_idx=state.frame_idx + 1)

    is_kf = _is_keyframe(opts, state, R_new, t_new)

    def on_kf(s):
        return _push_keyframe(
            opts, s, scan.xyz, scan.mask, R_new, t_new,
            edge_xyz=None if edge_scan is None else edge_scan.xyz,
            edge_mask=None if edge_scan is None else edge_scan.mask)

    state = jax.lax.cond(is_kf, on_kf, lambda s: s, state)
    return state, StepResult(R=R_new, t=t_new, is_keyframe=is_kf,
                             converged=res.converged,
                             num_effective=res.num_effective,
                             iterations=res.iterations, chi2=res.chi2)


@functools.partial(jax.jit, static_argnames=("opts",))
def step_measure(state: LioState, scan: PointCloud,
                 imu_gyro: jax.Array, imu_acce: jax.Array,
                 imu_stamp: jax.Array, imu_valid: jax.Array,
                 opts: LioOptions, edge_scan: Optional[PointCloud] = None):
    """Lio::AddMeasure (lio.cpp:412-444): ESKF-predict through the measure
    group's padded IMU packet, then AddCloud."""
    new_eskf = eskf_mod.predict_scan(
        state.eskf, imu_gyro, imu_acce, imu_stamp, imu_valid, eskf_mod.EskfOptions())
    return step(state._replace(eskf=new_eskf), scan, opts, edge_scan=edge_scan)


@functools.partial(jax.jit, static_argnames=("opts",))
def preprocess_scan(opts: LioOptions, xyz: jax.Array, mask: jax.Array) -> PointCloud:
    """Voxel-filter a raw padded scan down to `scan_capacity` rows
    (lio.cpp:240: cur_scan_filter)."""
    pc = PointCloud(xyz=xyz, mask=mask)
    # Center the downsample key window on the scan so far-range returns
    # survive; compaction puts the surviving voxels in a dense prefix.
    centroid = jnp.sum(jnp.where(mask[:, None], xyz, 0.0), axis=0) / jnp.maximum(
        jnp.sum(mask.astype(jnp.float32)), 1.0)
    ds = voxel_ops.voxel_downsample(pc, opts.scan_filter_leaf, origin=centroid)
    n = opts.scan_capacity
    if ds.capacity < n:
        raise ValueError("scan capacity exceeds raw capacity")
    order = jnp.argsort(~ds.mask, stable=True)[:n]
    return PointCloud(xyz=ds.xyz[order], mask=ds.mask[order])


# ---------------------------------------------------------------------------
# Host driver (the stateful convenience wrapper, mirroring the C++ object)
# ---------------------------------------------------------------------------

class ImuStaticInit:
    """Host wrapper of the static-IMU seed flow (StaticIMUInit::AddIMU +
    TryInit, lio.cpp:70-99): buffers samples until a stationary window of
    init_time_seconds passes the variance gates, then returns the seeded
    EskfState ONCE. Shared by Lio and the sharded mapping pipeline."""

    def __init__(self):
        self.buffer: list[tuple[float, np.ndarray, np.ndarray]] = []

    def add(self, gyro, acce, timestamp):
        """Returns the seeded EskfState when ready, else None."""
        self.buffer.append((float(timestamp), np.asarray(gyro),
                            np.asarray(acce)))
        if len(self.buffer) < 10:
            return None
        t0, t1 = self.buffer[0][0], self.buffer[-1][0]
        if t1 - t0 < eskf_mod.ImuInitOptions().init_time_seconds:
            return None
        gyros = jnp.asarray(np.stack([g for _, g, _ in self.buffer]),
                            jnp.float32)
        acces = jnp.asarray(np.stack([a for _, _, a in self.buffer]),
                            jnp.float32)
        valid = jnp.ones((gyros.shape[0],), bool)
        res = eskf_mod.static_imu_init(gyros, acces, valid)
        if not bool(res.success):
            self.buffer.pop(0)
            return None
        return eskf_mod.init_state(bg=res.bg, ba=res.ba,
                                   gravity=res.gravity, time=t1)


class Lio:
    """Stateful wrapper: owns a LioState, records keyframe poses, exposes the
    reference's object API (AddCloud/AddMeasure/InitImu/GetAllKeyFramePose,
    lio.hpp:53-147)."""

    def __init__(self, opts: LioOptions = LioOptions(), R_il=None, t_il=None,
                 pipelined: bool = False):
        from ..utils import health as health_mod

        self.opts = opts
        self.state = init_state(opts, R_il, t_il)
        # lag-1 pipelining (see add_measure): exact, poses lag one scan;
        # keep False when a caller consumes the return value per scan
        # (slam3d's loop machinery does)
        self.pipelined = pipelined
        self._pend_out: Optional[StepResult] = None
        self.poses: list[np.ndarray] = []        # per-frame 4x4 T_w_l
        self.kf_poses: list[np.ndarray] = []
        self._imu_init = ImuStaticInit()
        self.imu_inited = not opts.with_eskf
        # system-level failure detection (SURVEY.md section 5: the reference
        # has none) — fed from the same batched pull as the pose record.
        # MATCHER-AWARE residual gate (round-5 soak finding): the NDT
        # matchers report an info-WEIGHTED chi2 (Mahalanobis^2 per
        # residual, outlier-gated at 20), not the metric m^2 the ICP paths
        # report — under the 1.0 m^2 default every healthy NDT frame
        # flagged "bad" and the monitor sat at LOST for an entire soak run
        # at 0.07 m ATE. Half the NDT outlier gate is the working
        # threshold; metric matchers keep the metric default.
        self.health = health_mod.TrackingHealth(
            health_mod.HealthOptions(max_chi2_per_point=10.0)
            if opts.matcher.startswith("ndt")
            else health_mod.HealthOptions())

    # -- IMU ----------------------------------------------------------------
    def init_imu(self, gyro, acce, timestamp) -> bool:
        """StaticIMUInit::AddIMU + TryInit (lio.cpp:70-99). Returns True once
        the filter is seeded."""
        if self.imu_inited:
            return True
        st = self._imu_init.add(gyro, acce, timestamp)
        if st is None:
            return False
        self.state = self.state._replace(eskf=st)
        self.imu_inited = True
        return True

    # -- data ---------------------------------------------------------------
    def add_cloud(self, scan: PointCloud, edge_scan: Optional[PointCloud] = None):
        self.state, out = step(self.state, scan, self.opts, edge_scan=edge_scan)
        if self.pipelined:
            prev, self._pend_out = self._pend_out, out
            if prev is not None:
                self._record(prev)
            return prev
        self._record(out)
        return out

    def add_measure(self, scan: PointCloud, imu_gyro, imu_acce, imu_stamp,
                    imu_valid, edge_scan: Optional[PointCloud] = None):
        self.state, out = step_measure(
            self.state, scan, imu_gyro, imu_acce, imu_stamp, imu_valid,
            self.opts, edge_scan=edge_scan)
        if self.pipelined:
            # lag-1: the WHOLE per-scan flow is one jitted step and the
            # host record feeds nothing back, so pulling the PREVIOUS
            # scan's result while this one computes hides the pull
            # exactly (the 2D engine's pipelined mode needs replay for its
            # host-side lifecycle; Lio does not). Returns the previous
            # StepResult (None on the first call); flush() drains the tail.
            prev, self._pend_out = self._pend_out, out
            if prev is not None:
                self._record(prev)
            return prev
        self._record(out)
        return out

    def flush(self) -> Optional[StepResult]:
        """Drain the pipelined tail (no-op in sequential mode)."""
        out, self._pend_out = self._pend_out, None
        if out is not None:
            self._record(out)
        return out

    def _record(self, out: StepResult):
        # ONE batched device->host pull: every transfer pays a round trip
        # and a sync, so fetching R, t and the keyframe flag separately
        # triples the per-scan host cost; device_get also populates each array's
        # host cache, making callers' later bool(out.is_keyframe) free.
        R, t, is_kf, conv, n_eff, chi2 = jax.device_get(
            (out.R, out.t, out.is_keyframe, out.converged,
             out.num_effective, out.chi2))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        self.poses.append(T)
        if bool(is_kf):
            self.kf_poses.append(T)
        if len(self.poses) > 1:  # frame 0 does no matching (lio.cpp:224-233)
            self.health.update(conv, n_eff, chi2)

    def apply_correction(self, dR: np.ndarray, dt: np.ndarray) -> None:
        """Left-multiply every live world pose by the SE(3) correction
        T_corr = (dR, dt) — used by the pose-graph back-end to snap the
        front-end onto the optimized trajectory (the 3D analog of the 2D
        write-back, loop_closing.cpp:247-255). The ESKF nominal (p, v, R)
        rotates with the world poses; gravity is untouched — loop
        corrections of a gravity-aligned map are yaw-dominant, and the
        filter re-estimates any residual tilt within a few updates.
        """
        dR = jnp.asarray(dR, jnp.float32)
        dt = jnp.asarray(dt, jnp.float32)
        s = self.state
        fix = lambda R, t: lie.se3_compose(dR, dt, R, t)
        R, t = fix(s.R, s.t)
        last_R, last_t = fix(s.last_R, s.last_t)
        lk_R, lk_t = fix(s.last_kf_R, s.last_kf_t)
        kf_R, kf_t = jax.vmap(fix)(s.kf_R, s.kf_t)
        e = s.eskf
        e = e._replace(R=dR @ e.R, p=e.p @ dR.T + dt, v=e.v @ dR.T)
        self.state = s._replace(R=R, t=t, last_R=last_R, last_t=last_t,
                                kf_R=kf_R, kf_t=kf_t,
                                last_kf_R=lk_R, last_kf_t=lk_t, eskf=e)

    # -- map export (GetLocalMap / GetGlobalMap, lio.cpp:550-614) ------------
    def local_map(self) -> np.ndarray:
        s = self.state
        world = np.einsum("kij,knj->kni", np.asarray(s.kf_R), np.asarray(s.kf_xyz)) \
            + np.asarray(s.kf_t)[:, None, :]
        mask = np.asarray(s.kf_mask)
        return world[mask]

    def keyframe_poses(self) -> np.ndarray:
        return np.stack(self.kf_poses) if self.kf_poses else np.zeros((0, 4, 4))
