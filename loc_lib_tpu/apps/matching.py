"""Localization app: map-based matching over a replayed log.

Rebuild of `lio_matching_node` + `LioMatchingFlow` (/root/reference/
slam_demo/src/apps/lio_matching_node.cpp:12-29, slam_demo/src/matching/3d/
lio_matching_flow.cpp): load the global map (loc.cpp:268-283), seed the
initial pose (GNSS+IMU in the reference, cpp:198-264; here GNSS ENU when the
log has fixes, else ground truth/identity), then per scan: ESKF predict
through the IMU packet, box-cropped scan match, re-crop near the box edge
(loc.cpp:208-247).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..io import config as config_io, logdir, trajectory
from ..io.replay import EnuConverter
from ..ops.pointcloud import PointCloud
from ..pipeline import loc as loc_mod
from ..utils.timing import StageTimer
from ..utils import compile_cache


def run_matching(log: logdir.SensorLog, global_map_xyz: np.ndarray,
                 opts: loc_mod.LocOptions, out_dir: str,
                 init_pose: np.ndarray | None = None,
                 mp_shards: int = 0,
                 shard_capacity: int | None = None,
                 init_velocity: np.ndarray | None = None) -> dict:
    """mp_shards > 0 runs the spatially sharded Loc (pipeline/loc_sharded):
    the box-cropped local map partitioned over an mp-axis mesh so the map
    working set scales past one device's HBM (the scaled analog of
    loc.cpp:187-206's 150 m box). `init_velocity` (3,) seeds the ESKF's
    world-frame velocity along with the initial pose; without it the
    filter starts at rest."""
    os.makedirs(out_dir, exist_ok=True)
    import jax.numpy as jnp

    if mp_shards > 0:
        import jax
        from ..parallel import mesh as mesh_mod
        from ..pipeline import loc_sharded

        dp = max(1, jax.device_count() // mp_shards)
        mesh = mesh_mod.make_mesh_2d(dp, mp_shards)
        engine = loc_sharded.LocSharded(mesh, global_map_xyz, opts,
                                        shard_capacity=shard_capacity)
    else:
        engine = loc_mod.Loc(global_map_xyz, opts)

    # initial pose: explicit > GNSS first fix > identity (cpp:198-264)
    if init_pose is None and log.gnss is not None and len(log.gnss.stamps):
        enu = EnuConverter(*log.gnss.lla[0])
        init_pose = np.eye(4, dtype=np.float32)
        init_pose[:3, 3] = enu.to_enu(*log.gnss.lla[0])
    if init_pose is None:
        init_pose = np.eye(4, dtype=np.float32)
    engine.set_init_pose(init_pose[:3, :3], init_pose[:3, 3], init_velocity)

    timer = StageTimer()
    stamps, frame_idxs = [], []
    t_fix = None
    for mg in log.measures(imu_capacity=64):
        scan = PointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                          mask=jnp.asarray(log.scan_mask[mg.scan_index]))
        # the initial fix holds at the first scan: IMU samples up to it
        # happened before that pose and velocity and are not integrated
        if t_fix is None:
            t_fix = mg.scan_stamp
        imu_valid = np.asarray(mg.imu_valid) & (np.asarray(mg.imu_stamp)
                                                > t_fix)
        with timer.stage("loc_step"):
            # IMU packet + scan as ONE device program (the reference polls
            # Update(imu) per sample at 200 Hz; here the packet rides a
            # lax.scan inside the same jit as the match)
            engine.update_measure(scan, mg.imu_gyro, mg.imu_acce,
                                  mg.imu_stamp, imu_valid)
        stamps.append(mg.scan_stamp)
        frame_idxs.append(mg.scan_index)

    poses = np.stack(engine.poses) if engine.poses else np.zeros((0, 4, 4))
    trajectory.save_kitti(os.path.join(out_dir, "trajectory_kitti.txt"), poses)
    trajectory.save_tum(os.path.join(out_dir, "trajectory_tum.txt"),
                        np.asarray(stamps), poses)
    report = {"frames": len(poses), "stage_ms": timer.report()}
    if log.gt_poses is not None and len(poses):
        from ..eval.metrics import ate
        report["ate_rmse_m"] = float(
            ate(poses, log.gt_poses[np.asarray(frame_idxs)]).rmse)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def demo_inputs(num_frames: int, capacity: int = 8192):
    """The `--demo` inputs: a synthetic log of `capacity`-point scans along
    the demo arc at 2 m/s, the 120k-point world it was rendered from as the
    prior map, and the ground-truth pose and velocity at the first measure
    group as the initial fix (what a GNSS/INS fix would give)."""
    from ..io import synthetic
    log = logdir.make_demo_log(num_frames=num_frames, capacity=capacity)
    gmap = synthetic.make_world(num_points=120000, extent=80.0, seed=0)
    k = next(iter(log.measures())).scan_index
    init_pose = log.gt_poses[k]
    dt = log.scan_stamps[k + 1] - log.scan_stamps[k]
    init_velocity = (log.gt_poses[k + 1, :3, 3] - init_pose[:3, 3]) / dt
    return log, gmap, init_pose, init_velocity.astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log", help="sensor log directory")
    ap.add_argument("--map", help="global map (.npz with xyz, or .pcd)")
    ap.add_argument("--demo", action="store_true",
                    help="synthesize log + map (mapping-free localization demo)")
    ap.add_argument("--demo-frames", type=int, default=20)
    ap.add_argument("--config", help="slam.yaml-style config file")
    ap.add_argument("--out", default="./matching_out")
    ap.add_argument("--mp-shards", type=int, default=0,
                    help="shard the local map over this many devices "
                         "(0 = single-device Loc)")
    ap.add_argument("--shard-capacity", type=int, default=None,
                    help="per-shard point budget (default: "
                         "2*local_map_capacity/mp)")
    args = ap.parse_args(argv)
    compile_cache.enable()

    init_pose = init_velocity = None
    if args.demo:
        log, gmap, init_pose, init_velocity = demo_inputs(args.demo_frames)
    else:
        if not (args.log and args.map):
            ap.error("--log and --map, or --demo, required")
        log = logdir.load_log(args.log)
        if args.map.endswith(".pcd"):
            from ..io.pcd import load_pcd
            gmap = load_pcd(args.map)
        else:
            gmap = np.load(args.map)["xyz"]

    if args.config:
        cfg = config_io.Config.from_file(args.config)
        opts = config_io.loc_options(cfg)
    else:
        opts = loc_mod.LocOptions(scan_capacity=log.scan_xyz.shape[1])

    report = run_matching(log, gmap, opts, args.out, init_pose=init_pose,
                          mp_shards=args.mp_shards,
                          shard_capacity=args.shard_capacity,
                          init_velocity=init_velocity)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
