"""Mapping app: LIO over a replayed log -> keyframes, global map, trajectory.

Rebuild of `lio_mapping_node` + `LioMappingFlow` (/root/reference/slam_demo/
src/apps/lio_mapping_node.cpp:83-110, slam_demo/src/mapping/3d/
lio_mapping_flow.cpp): config -> options (cpp:51-135), static-IMU init
(cpp:17-31), GNSS ENU origin from the first fix (cpp:33-49), the per-scan
update (cpp:332-347), and the save-map/trajectory command (cpp:378-418) —
with ROS ingestion replaced by the offline log replay and the save-map
thread replaced by synchronous export plus rolling state checkpoints
(SURVEY.md section 5's checkpoint/resume upgrade).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..io import checkpoint as ckpt_io, config as config_io, logdir, trajectory
from ..io.replay import EnuConverter
from ..ops.pointcloud import PointCloud
from ..pipeline import lio as lio_mod
from ..utils.timing import StageTimer
from ..utils import compile_cache


def run_mapping(log: logdir.SensorLog, opts: lio_mod.LioOptions,
                out_dir: str, ckpt_every: int = 0,
                resume: bool = False, use_orbax=None,
                mp_shards: int = 0) -> dict:
    """use_orbax: None = auto (orbax when importable, the production path);
    False forces the npz fallback.

    mp_shards > 0 runs the spatially sharded mapping pipeline
    (pipeline/lio_sharded): the incremental voxel map partitioned over an
    mp-axis mesh so the MAPPING working set scales past one device's HBM —
    the scaled analog of the reference's 100k-voxel LRU table
    (ndt_registration.cpp:150-174). Requires matcher='ndt_inc';
    checkpoint/resume stays single-device for now."""
    os.makedirs(out_dir, exist_ok=True)
    import jax.numpy as jnp

    if mp_shards > 0:
        import jax
        from ..parallel import mesh as mesh_mod
        from ..pipeline import lio_sharded

        assert opts.matcher == "ndt_inc", (
            "sharded mapping runs the incremental NDT matcher "
            f"(got {opts.matcher!r})")
        assert not ckpt_every and not resume, (
            "checkpoint/resume is single-device-only")
        dp = max(1, jax.device_count() // mp_shards)
        engine = lio_sharded.LioSharded(
            mesh_mod.make_mesh_2d(dp, mp_shards), opts)
    else:
        engine = lio_mod.Lio(opts)
    kf_store = ckpt_io.KeyframeStore(os.path.join(out_dir, "key_frames"),
                                     fresh=not resume)
    ckpt = ckpt_io.Checkpointer(os.path.join(out_dir, "ckpt"),
                                use_orbax=use_orbax) if ckpt_every else None
    start = 0
    if resume and ckpt is not None and ckpt.latest() is not None:
        engine.state, start = ckpt.restore(engine.state)
        start += 1
        engine.imu_inited = True

    enu = None
    timer = StageTimer()
    stamps = []
    frame_idxs = []
    for mg in log.measures(imu_capacity=64):
        if mg.scan_index < start:
            continue
        # static IMU init gate (lio_mapping_flow.cpp:17-31)
        if opts.with_eskf and not engine.imu_inited and log.imu is not None:
            sel = log.imu.stamps <= mg.scan_stamp
            for t, g, a in zip(log.imu.stamps[sel][-400:],
                               log.imu.gyro[sel][-400:], log.imu.acce[sel][-400:]):
                engine.init_imu(g, a, t)
            if not engine.imu_inited:
                continue  # still stationary-collecting; skip scan like the flow
        if mg.gnss is not None and enu is None:
            enu = EnuConverter(*mg.gnss[:3])  # first fix = ENU origin
        scan = PointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                          mask=jnp.asarray(log.scan_mask[mg.scan_index]))
        with timer.stage("lio_step"):
            out = engine.add_measure(scan, jnp.asarray(mg.imu_gyro),
                                     jnp.asarray(mg.imu_acce),
                                     jnp.asarray(mg.imu_stamp),
                                     jnp.asarray(mg.imu_valid))
        stamps.append(mg.scan_stamp)
        frame_idxs.append(mg.scan_index)
        if bool(out.is_keyframe):
            with timer.stage("kf_store"):
                xyz = log.scan_xyz[mg.scan_index][log.scan_mask[mg.scan_index]]
                kf_store.append(xyz, engine.poses[-1])
        if ckpt is not None and ckpt_every and \
                (mg.scan_index + 1) % ckpt_every == 0:
            ckpt.save(mg.scan_index, engine.state)

    # exports (SaveGlobalMap + SavePose, lio_mapping_flow.cpp:378-418)
    poses = np.stack(engine.poses) if engine.poses else np.zeros((0, 4, 4))
    trajectory.save_kitti(os.path.join(out_dir, "trajectory_kitti.txt"), poses)
    trajectory.save_tum(os.path.join(out_dir, "trajectory_tum.txt"),
                        np.asarray(stamps), poses)
    gmap = kf_store.assemble_global_map(voxel_size=0.3)
    np.savez(os.path.join(out_dir, "global_map.npz"), xyz=gmap)
    # rendered observability (the rviz map+odom topics' artifact analog,
    # lio_mapping_flow.cpp:150-155 — see io/viz.py)
    from ..io import viz
    viz.write_png(
        os.path.join(out_dir, "map_topdown.png"),
        viz.render_map_topdown(
            gmap, traj_t=poses[:, :3, 3] if len(poses) else None,
            ref_t=(log.gt_poses[np.asarray(frame_idxs)][:, :3, 3]
                   if log.gt_poses is not None and frame_idxs else None)))
    report = {"frames": len(poses), "keyframes": len(kf_store),
              "map_points": int(len(gmap)), "stage_ms": timer.report()}
    if mp_shards > 0:
        report["mp_shards"] = mp_shards
        report["live_voxels_per_shard"] = [
            int(v) for v in engine.live_voxels_per_shard()]
    # ATE vs ground truth when the log carries it (BASELINE.md plan item 3:
    # the reference never measured this — eyeballed in rviz, SURVEY.md §4)
    if log.gt_poses is not None and len(poses) >= 3:
        from ..eval import metrics
        a = metrics.ate(poses, log.gt_poses[np.asarray(frame_idxs)])
        report["ate_rmse_m"] = round(a.rmse, 4)
        report["ate_max_m"] = round(a.max, 4)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log", help="sensor log directory (io.logdir format)")
    ap.add_argument("--demo", action="store_true",
                    help="synthesize a demo log instead of reading --log")
    ap.add_argument("--demo-frames", type=int, default=30)
    ap.add_argument("--config", help="slam.yaml-style config file")
    ap.add_argument("--out", default="./mapping_out")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint the LIO state every N scans (0 = off)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-orbax", action="store_true",
                    help="force the npz checkpoint fallback instead of orbax")
    ap.add_argument("--mp-shards", type=int, default=0,
                    help="shard the incremental voxel map over this many "
                         "mesh 'mp' slices (matcher becomes ndt_inc; the "
                         "mapping working set scales past one device)")
    args = ap.parse_args(argv)
    compile_cache.enable()

    if args.demo:
        log = logdir.make_demo_log(num_frames=args.demo_frames)
    else:
        if not args.log:
            ap.error("--log or --demo required")
        log = logdir.load_log(args.log)

    if args.config:
        cfg = config_io.Config.from_file(args.config)
        opts = config_io.lio_options(cfg)
    else:
        opts = lio_mod.LioOptions(scan_capacity=log.scan_xyz.shape[1])
    if args.mp_shards > 0 and opts.matcher != "ndt_inc":
        import dataclasses
        opts = dataclasses.replace(opts, matcher="ndt_inc")

    report = run_mapping(log, opts, args.out, ckpt_every=args.ckpt_every,
                         resume=args.resume,
                         use_orbax=False if args.no_orbax else None,
                         mp_shards=args.mp_shards)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
