"""LOC: localization against a prior global map.

Rebuild of the reference `class Loc`
(/root/reference/LocUtils/src/slam/3d/loc.cpp, include .../slam/3d/loc.hpp).

Dataflow parity:
  * InitGlobalMap (loc.cpp:268-283)  -> the global map lives as one padded
    device/host tensor (`GlobalMap`), loaded once.
  * ResetLocalMap (loc.cpp:187-206)  -> `crop_local_map`: a box mask +
    stable compaction replaces pcl::CropBox, then the matcher target is
    rebuilt over the crop.
  * Update(cloud) (loc.cpp:208-247)  -> `step`: ESKF/const-velocity predict,
    scan match, ESKF observe, and an on-device `need_recrop` test replacing
    the box-edge check (re-crop when within `recrop_margin` of the box edge,
    loc.cpp:235-246).
  * Update(imu) (loc.cpp:256-266)    -> `predict_imu`.
  * SetInitPose (loc.cpp:171-185)    -> `set_init_pose`.

The infrequent, data-dependent re-crop runs on the host driver (`Loc`), the
same host/device split the reference has between its 200 Hz poll loop and the
matcher — everything per-scan is a single jitted program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pointcloud import PointCloud, PAD_COORD, from_numpy
from ..ops import voxel as voxel_ops
from ..models import icp, ndt, eskf as eskf_mod
from ..utils import lie


@dataclasses.dataclass(frozen=True)
class LocOptions:
    """Mirror of LocOptions (loc.hpp:29-43) + static shape knobs.

    The ICP default is the PRODUCTION path (p2plane_vox: per-voxel plane
    table built once per box crop, one batched linearization per GN
    iteration) — the 131k-point crop is rebuilt only every ~50 m
    (recrop_margin), so its set_target cost amortizes over hundreds of
    scans while every scan avoids the per-point 5-NN + eigh of the oracle
    p2plane path (icp_registration.cpp:161-213 behavior, kept for parity
    tests via IcpOptions(method="p2plane"))."""

    matcher: str = "icp"                # icp | ndt
    icp: icp.IcpOptions = icp.IcpOptions(method="p2plane_vox")
    ndt: ndt.NdtOptions = ndt.NdtOptions()
    box_size: float = 150.0             # box_filter_size (m, cube edge)
    recrop_margin: float = 50.0         # re-crop when this close to an edge
    scan_filter_leaf: float = 1.0
    scan_capacity: int = 8192
    local_map_capacity: int = 131072
    with_eskf: bool = True


class LocState(NamedTuple):
    R: jax.Array
    t: jax.Array
    last_R: jax.Array
    last_t: jax.Array
    icp_target: Optional[icp.IcpTarget]
    ndt_map: Optional[ndt.NdtMap]
    map_center: jax.Array        # (3,) center of the current box crop
    eskf: eskf_mod.EskfState
    R_il: jax.Array
    t_il: jax.Array
    initialized: jax.Array       # () bool — pose seeded


class StepResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    converged: jax.Array
    num_effective: jax.Array
    chi2: jax.Array
    need_recrop: jax.Array


@functools.partial(jax.jit, static_argnames=("capacity",))
def crop_local_map(map_xyz: jax.Array, map_mask: jax.Array, center: jax.Array,
                   half_size: float, capacity: int) -> PointCloud:
    """Box-crop the global map around `center` into a fixed-capacity cloud
    (BoxFilter semantics, box_filter.cpp:25-57)."""
    inside = map_mask & jnp.all(jnp.abs(map_xyz - center) <= half_size, axis=-1)
    order = jnp.argsort(~inside, stable=True)[:capacity]
    xyz = jnp.where(inside[order][:, None], map_xyz[order], PAD_COORD)
    return PointCloud(xyz=xyz, mask=inside[order])


def _build_target(opts: LocOptions, local_map: PointCloud, origin):
    if opts.matcher == "icp":
        return {"icp_target": icp.set_target(local_map, opts.icp, origin)}
    if opts.matcher == "ndt":
        return {"ndt_map": ndt.build_direct(local_map, opts.ndt, origin)}
    raise ValueError(opts.matcher)


def init_state(opts: LocOptions, R_il=None, t_il=None) -> LocState:
    eye = jnp.eye(3, dtype=jnp.float32)
    z3 = jnp.zeros((3,), jnp.float32)
    empty = PointCloud(xyz=jnp.full((opts.local_map_capacity, 3), PAD_COORD, jnp.float32),
                       mask=jnp.zeros((opts.local_map_capacity,), bool))
    st = LocState(
        R=eye, t=z3, last_R=eye, last_t=z3,
        icp_target=None, ndt_map=None,
        map_center=z3,
        eskf=eskf_mod.init_state(),
        R_il=eye if R_il is None else jnp.asarray(R_il, jnp.float32),
        t_il=z3 if t_il is None else jnp.asarray(t_il, jnp.float32),
        initialized=jnp.bool_(False),
    )
    return st._replace(**_build_target(opts, empty, z3))


@functools.partial(jax.jit, static_argnames=("opts",))
def step(state: LocState, scan: PointCloud, opts: LocOptions):
    """Loc::Update(cloud) (loc.cpp:208-247)."""
    if opts.with_eskf:
        Ri, ti = eskf_mod.nominal_se3(state.eskf)
        R0, t0 = lie.se3_compose(Ri, ti, state.R_il, state.t_il)
    else:
        dR, dt = lie.se3_compose(state.R, state.t,
                                 *lie.se3_inverse(state.last_R, state.last_t))
        R0, t0 = lie.se3_compose(dR, dt, state.R, state.t)

    if opts.matcher == "icp":
        res = icp.scan_match(state.icp_target, opts.icp, scan, R0, t0)
    else:
        res = ndt.scan_match(state.ndt_map, opts.ndt, scan, R0, t0)

    R_new, t_new = res.R, res.t
    if opts.with_eskf:
        Ril_inv, til_inv = lie.se3_inverse(state.R_il, state.t_il)
        R_imu, t_imu = lie.se3_compose(R_new, t_new, Ril_inv, til_inv)
        new_eskf = eskf_mod.observe_se3(state.eskf, R_imu, t_imu, eskf_mod.EskfOptions())
        Ri, ti = eskf_mod.nominal_se3(new_eskf)
        R_new, t_new = lie.se3_compose(Ri, ti, state.R_il, state.t_il)
    else:
        new_eskf = state.eskf

    # Box-edge proximity test (loc.cpp:235-246).
    dist_to_edge = opts.box_size / 2.0 - jnp.max(jnp.abs(t_new - state.map_center))
    need_recrop = dist_to_edge < opts.recrop_margin

    state = state._replace(last_R=state.R, last_t=state.t, R=R_new, t=t_new,
                           eskf=new_eskf)
    return state, StepResult(R=R_new, t=t_new, converged=res.converged,
                             num_effective=res.num_effective, chi2=res.chi2,
                             need_recrop=need_recrop)


@jax.jit
def predict_imu(state: LocState, gyro, acce, timestamp):
    """Loc::Update(imu) (loc.cpp:256-266)."""
    return state._replace(eskf=eskf_mod.predict(
        state.eskf, gyro, acce, timestamp, eskf_mod.EskfOptions()))


@functools.partial(jax.jit, static_argnames=("opts",))
def step_measure(state: LocState, scan: PointCloud,
                 imu_gyro: jax.Array, imu_acce: jax.Array,
                 imu_stamp: jax.Array, imu_valid: jax.Array,
                 opts: LocOptions):
    """One measure group: ESKF-predict through the padded IMU packet with a
    single `lax.scan`, then the scan update — one jitted program per frame
    (the per-sample Update(imu) poll loop of the reference's 200 Hz flow,
    lio_matching_flow.cpp:89-162, fused device-side)."""
    new_eskf = eskf_mod.predict_scan(
        state.eskf, imu_gyro, imu_acce, imu_stamp, imu_valid,
        eskf_mod.EskfOptions())
    return step(state._replace(eskf=new_eskf), scan, opts)


def set_init_pose(state: LocState, R, t, v=None) -> LocState:
    """SetInitPose (loc.cpp:171-185): seed pose + ESKF nominal, and the
    world-frame velocity when one is known (`v`, (3,)); without it the
    ESKF starts at rest."""
    R = jnp.asarray(R, jnp.float32)
    t = jnp.asarray(t, jnp.float32)
    Ril_inv, til_inv = lie.se3_inverse(state.R_il, state.t_il)
    R_imu, t_imu = lie.se3_compose(R, t, Ril_inv, til_inv)
    return state._replace(
        R=R, t=t, last_R=R, last_t=t,
        eskf=eskf_mod.set_pose(state.eskf, R_imu, t_imu, v=v),
        initialized=jnp.bool_(True),
    )


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------

class Loc:
    """Stateful wrapper mirroring Loc (loc.hpp:45-113): owns the global map,
    re-crops the local map when the jitted step flags proximity to the box
    edge, and buffers the trajectory."""

    def __init__(self, global_map_xyz: np.ndarray, opts: LocOptions = LocOptions(),
                 R_il=None, t_il=None):
        from ..utils import health as health_mod

        self.opts = opts
        gm = from_numpy(global_map_xyz)
        self.map_xyz = gm.xyz
        self.map_mask = gm.mask
        self.state = init_state(opts, R_il, t_il)
        self.poses: list[np.ndarray] = []
        # tracking-health monitor: health.needs_reinit tells the flow to
        # re-seed via set_init_pose (GNSS in the reference) instead of
        # publishing a diverging pose
        self.health = health_mod.TrackingHealth(
            health_mod.HealthOptions(max_chi2_per_point=10.0)
            if opts.matcher.startswith("ndt")
            else health_mod.HealthOptions())

    def set_init_pose(self, R, t, v=None):
        self.state = set_init_pose(self.state, R, t, v)
        self.health.reset()
        self._recrop()

    def _recrop(self):
        center = self.state.t
        local = crop_local_map(self.map_xyz, self.map_mask, center,
                               self.opts.box_size / 2.0,
                               self.opts.local_map_capacity)
        # snap the target-build origin to the voxel grid: floor binning is
        # shift-invariant under integer-leaf shifts, so successive re-crops
        # (and the mp-sharded build, pipeline/loc_sharded.py) produce
        # IDENTICAL voxel partitions instead of ones offset by the
        # fractional part of the pose
        leaf = (self.opts.icp.grid_leaf if self.opts.matcher == "icp"
                else self.opts.ndt.voxel_size)
        origin = jnp.floor(center / leaf) * leaf
        self.state = self.state._replace(
            map_center=center, **_build_target(self.opts, local, origin))

    def update_cloud(self, scan: PointCloud) -> StepResult:
        self.state, out = step(self.state, scan, self.opts)
        # one batched device->host pull per scan (see lio.Lio._record)
        R, t, recrop, conv, n_eff, chi2 = jax.device_get(
            (out.R, out.t, out.need_recrop, out.converged,
             out.num_effective, out.chi2))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        self.poses.append(T)
        self.health.update(conv, n_eff, chi2)
        if bool(recrop):
            self._recrop()
        return out

    def update_imu(self, gyro, acce, timestamp):
        self.state = predict_imu(self.state,
                                 jnp.asarray(gyro, jnp.float32),
                                 jnp.asarray(acce, jnp.float32),
                                 jnp.float32(timestamp))

    def update_measure(self, scan: PointCloud, imu_gyro, imu_acce, imu_stamp,
                       imu_valid) -> StepResult:
        """One measure group (IMU packet + scan) as a single device program;
        same host-side recrop/record handling as update_cloud."""
        self.state, out = step_measure(
            self.state, scan, jnp.asarray(imu_gyro), jnp.asarray(imu_acce),
            jnp.asarray(imu_stamp), jnp.asarray(imu_valid), self.opts)
        R, t, recrop, conv, n_eff, chi2 = jax.device_get(
            (out.R, out.t, out.need_recrop, out.converged,
             out.num_effective, out.chi2))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        self.poses.append(T)
        self.health.update(conv, n_eff, chi2)
        if bool(recrop):
            self._recrop()
        return out

    def current_pose(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(self.state.R)
        T[:3, 3] = np.asarray(self.state.t)
        return T
