"""SLAM app: full 3D SLAM (LIO + loop closure + pose graph) over a log.

The reference's mapping node (slam_demo/src/apps/lio_mapping_node.cpp) has
no 3D loop closure (SURVEY.md section 2: ScanContext retrieval is a stub,
3D has no pose graph); this driver is the completed version: the mapping
flow of apps/mapping.py with the Slam3d back-end, exporting both the raw
odometry and the loop-optimized trajectory plus the re-assembled map.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from ..io import logdir, trajectory
from ..ops.pointcloud import PointCloud
from ..pipeline import lio as lio_mod, slam3d
from ..utils.timing import StageTimer
from ..utils import compile_cache


def run_slam(log: logdir.SensorLog, opts: slam3d.Slam3dOptions,
             out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    import jax.numpy as jnp

    engine = slam3d.Slam3d(opts)
    timer = StageTimer()
    stamps, odom_poses, frame_idxs = [], [], []
    for mg in log.measures(imu_capacity=64):
        if opts.lio.with_eskf and not engine.imu_inited and log.imu is not None:
            sel = log.imu.stamps <= mg.scan_stamp
            for t, g, a in zip(log.imu.stamps[sel][-400:],
                               log.imu.gyro[sel][-400:],
                               log.imu.acce[sel][-400:]):
                engine.init_imu(g, a, t)
            if not engine.imu_inited:
                continue
        scan = PointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                          mask=jnp.asarray(log.scan_mask[mg.scan_index]))
        with timer.stage("slam_step"):
            out = engine.add_measure(scan, jnp.asarray(mg.imu_gyro),
                                     jnp.asarray(mg.imu_acce),
                                     jnp.asarray(mg.imu_stamp),
                                     jnp.asarray(mg.imu_valid))
        stamps.append(mg.scan_stamp)
        frame_idxs.append(mg.scan_index)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(out.R)
        T[:3, 3] = np.asarray(out.t)
        odom_poses.append(T)

    with timer.stage("final_optimize"):
        engine.optimize()

    odom = np.stack(odom_poses) if odom_poses else np.zeros((0, 4, 4))
    trajectory.save_kitti(os.path.join(out_dir, "odometry_kitti.txt"), odom)
    kf = engine.keyframe_poses()
    trajectory.save_kitti(os.path.join(out_dir, "keyframes_optimized_kitti.txt"), kf)
    gmap = engine.assemble_global_map(voxel_size=0.3)
    np.savez(os.path.join(out_dir, "global_map.npz"), xyz=gmap)
    # rendered observability: optimized map + odometry vs optimized keyframe
    # trajectory (the reference's live rviz topics as artifacts, io/viz.py)
    from ..io import viz
    viz.write_png(
        os.path.join(out_dir, "map_topdown.png"),
        viz.render_map_topdown(
            gmap, traj_t=kf[:, :3, 3] if len(kf) else None,
            ref_t=odom[:, :3, 3] if len(odom) else None))
    # last keyframe's ScanContext descriptor (the reference's OpenCV
    # dashboard, scan_context.cpp:25-50)
    if engine.scdb.count > 0:
        slot = (engine.scdb.count - 1) % engine.scdb.capacity
        viz.write_png(os.path.join(out_dir, "scan_context.png"),
                      viz.render_scan_context(engine.scdb.desc[slot]))
    report = {
        "frames": len(odom), "keyframes": len(engine.kf_R),
        "loops": len(engine.loops), "loop_batches": engine.loop_batches,
        "loop_inliers": int(engine.loop_inliers.sum())
        if engine.loop_inliers is not None else 0,
        "map_points": int(len(gmap)), "stage_ms": timer.report(),
    }
    if len(kf):
        # how far the pose graph moved the keyframes from their online poses
        kf_online = odom[np.asarray(engine.kf_frame)]
        report["pgo_max_shift_m"] = round(float(np.max(np.linalg.norm(
            kf[:, :3, 3] - kf_online[:, :3, 3], axis=1))), 4)
    # ATE vs ground truth when the log carries it: the odometry, and the
    # keyframes online and after the pose graph
    if log.gt_poses is not None and len(odom) >= 3:
        from ..eval import metrics
        gt = log.gt_poses[np.asarray(frame_idxs)]
        report["ate_rmse_m"] = round(metrics.ate(odom, gt).rmse, 4)
        if len(kf) >= 3:
            kf_gt = gt[np.asarray(engine.kf_frame)]
            report["kf_ate_online_m"] = round(
                metrics.ate(kf_online, kf_gt).rmse, 4)
            report["kf_ate_pgo_m"] = round(metrics.ate(kf, kf_gt).rmse, 4)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def demo_log(num_frames: int = 92, capacity: int = 8192) -> logdir.SensorLog:
    """The `--demo` log: 8,192-point scans every 0.2 s along a circle of
    1.9 m radius (1.4 m/s, 0.72 rad/s, 44 scans per lap) through a 32 m
    square world. The default 92 scans drive two laps, so the trajectory
    revisits its start and ScanContext has loops to find."""
    return logdir.make_demo_log(num_frames=num_frames, capacity=capacity,
                                dt=0.2, speed=1.4, yaw_rate=0.72,
                                world_points=40000, extent=16.0,
                                max_range=14.0)


def demo_options(scan_capacity: int = 8192) -> slam3d.Slam3dOptions:
    """Default options with two changes. The best three ScanContext
    candidates of each keyframe are re-registered together in one batched
    match (`LoopOptions.sc_topk`). Loop registration uses the odometry's
    1 m voxels: on the demo's dense scans of a small world, 2 m voxels mix
    ground and walls, few of them pass the plane fit (~400 of 8,192
    points), and the match slides metres away from a guess that was
    centimetres off."""
    opts = slam3d.Slam3dOptions(
        lio=lio_mod.LioOptions(scan_capacity=scan_capacity))
    return dataclasses.replace(
        opts, loop=dataclasses.replace(opts.loop, sc_topk=3),
        loop_icp=dataclasses.replace(opts.loop_icp, grid_leaf=1.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log", help="sensor log directory (io.logdir format)")
    ap.add_argument("--demo", action="store_true",
                    help="synthesize a two-lap circle (see demo_log)")
    ap.add_argument("--demo-frames", type=int, default=92)
    ap.add_argument("--out", default="./slam_out")
    args = ap.parse_args(argv)
    compile_cache.enable()

    if args.demo:
        log = demo_log(args.demo_frames)
        opts = demo_options(log.scan_xyz.shape[1])
    else:
        if not args.log:
            ap.error("--log or --demo required")
        log = logdir.load_log(args.log)
        opts = slam3d.Slam3dOptions(
            lio=lio_mod.LioOptions(scan_capacity=log.scan_xyz.shape[1]))
    print(json.dumps(run_slam(log, opts, args.out)))


if __name__ == "__main__":
    main()
