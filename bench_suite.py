"""Extended benchmark suite: BASELINE.md plan items 2-5 + device scaling.

bench.py is the one-line headline (single-GPU P2Plane scan-match
throughput vs the C++ baseline); this suite records the rest of the
BASELINE.md measurement plan:

  1. lio_full_log     — ESKF-LIO over a demo log: steady-state scans/s + ATE
                        (plan item 3; ref design point is a 10 Hz lidar,
                        lio_mapping_node.cpp:96).
  2. ndt_inc_odometry — incremental-NDT scan-to-map odometry over the same
                        log: scans/s + ATE (plan item 2; ref analog
                        ndt_registration.cpp:262-372 inside Lio).
  3. slam3d_loop      — full SLAM with ScanContext loop closure + two-phase
                        PGO on a two-lap trajectory: ATE before/after the
                        solve, warm-started first-call latency
                        (plan item 4; the reference's only PGO is 2D,
                        loop_closing.cpp:160-255).
  4. scaling          — the mp-sharded plane-table path vs map size on
                        the card, and the virtual-CPU mesh curve for
                        program-partition correctness (a child process on
                        the CPU: partitioning, not speedup).

Also: lio_sharded_mapping (the mp-sharded mapping pipeline),
matcher_variants (exact vs octant-pre-elected election), throughput_batched
(B-way scan_match_batch aggregate rates), mapping2d pipelined row (the
device-resident 2D engine), loam pipelined row.

Run on a machine with a GPU: python bench_suite.py [--quick]. Writes
chiprun_out/bench_suite.json; exits non-zero without a GPU or when any
section fails. The numbers of record are the benchmark ledger's.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def _setup_jax():
    import jax
    from loc_lib_tpu.utils import compile_cache
    compile_cache.enable()
    return jax


def bench_lio(matcher: str, frames: int, capacity: int,
              icp_method: str = "p2plane") -> dict:
    """Full-log LIO: steady-state scans/s + ATE vs the synthetic ground
    truth. Warmup frames (compile + first keyframe rebuild) are excluded
    from timing, like the reference's evaluate_and_call warmup."""
    jax = _setup_jax()
    import jax.numpy as jnp
    from loc_lib_tpu.io import logdir
    from loc_lib_tpu.ops.pointcloud import PointCloud
    from loc_lib_tpu.pipeline import lio as lio_mod
    from loc_lib_tpu.models import icp as icp_mod, ndt as ndt_mod
    from loc_lib_tpu.eval import metrics

    log = logdir.make_demo_log(num_frames=frames, capacity=capacity,
                               yaw_rate=0.0, speed=2.0)
    if matcher in ("icp", "icp_vox_inc"):
        opts = lio_mod.LioOptions(
            matcher=matcher, icp=icp_mod.IcpOptions(method=icp_method),
            scan_capacity=capacity, with_eskf=True)
    else:
        opts = lio_mod.LioOptions(
            matcher="ndt_inc",
            ndt=ndt_mod.NdtOptions(method="incremental", voxel_size=1.0),
            scan_capacity=capacity, with_eskf=True)
    engine = lio_mod.Lio(opts)
    # static init from the log's leading IMU window
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150],
                       log.imu.acce[:150]):
        engine.init_imu(g, a, t)
    assert engine.imu_inited
    engine_init_eskf = engine.state.eskf

    warmup = 6
    times, poses, idxs, dev_inputs = [], [], [], []
    state_w = None
    for mg in log.measures(imu_capacity=64):
        scan = PointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                          mask=jnp.asarray(log.scan_mask[mg.scan_index]))
        inp = (scan, jnp.asarray(mg.imu_gyro), jnp.asarray(mg.imu_acce),
               jnp.asarray(mg.imu_stamp), jnp.asarray(mg.imu_valid))
        dev_inputs.append(inp)
        t0 = time.perf_counter()
        out = engine.add_measure(inp[0], *inp[1:])
        jax.block_until_ready(out.t)
        times.append(time.perf_counter() - t0)
        idxs.append(mg.scan_index)
        if len(dev_inputs) == warmup:
            state_w = engine.state  # post-step snapshot: the pipelined
            #                         replay of dev_inputs[warmup:] continues
            #                         the chain with no skipped frame
    poses = np.stack(engine.poses)
    a = metrics.ate(poses, log.gt_poses[np.asarray(idxs)])
    steady = np.asarray(times[warmup:])

    # LAG-1 pipelined host loop (round 5): Lio's whole per-scan flow is
    # one jitted step and the host record feeds nothing back, so pulling
    # the previous result while the current scan computes hides the
    # per-scan pull exactly (poses lag one scan; flush() drains the tail).
    eng_l1 = lio_mod.Lio(opts, pipelined=True)
    eng_l1.state = eng_l1.state._replace(eskf=engine_init_eskf)
    eng_l1.imu_inited = True
    times_l1 = []
    for inp in dev_inputs:
        t0 = time.perf_counter()
        eng_l1.add_measure(inp[0], *inp[1:])
        times_l1.append(time.perf_counter() - t0)
    eng_l1.flush()
    steady_l1 = np.asarray(times_l1[warmup:])
    a_l1 = metrics.ate(np.stack(eng_l1.poses),
                       log.gt_poses[np.asarray(idxs)])

    # Pipelined device rate: the SAME steady-state frames dispatched
    # back-to-back from the pre-uploaded inputs with ONE final sync — the
    # throughput the device sustains when the host isn't pulling a pose per
    # scan.
    jax.block_until_ready(engine.state.t)
    # TWO passes, time the second: the first back-to-back pass pays a
    # per-call dispatch warmup that the steady stream does not.
    st = state_w
    for inp in dev_inputs[warmup:]:
        st, out = lio_mod.step_measure(st, inp[0], *inp[1:], opts)
    jax.block_until_ready(out.t)
    t0 = time.perf_counter()
    st = state_w
    for inp in dev_inputs[warmup:]:
        st, out = lio_mod.step_measure(st, inp[0], *inp[1:], opts)
    jax.block_until_ready(out.t)
    pipelined = (time.perf_counter() - t0) / len(dev_inputs[warmup:])
    return {
        "frames": frames,
        "scan_capacity": capacity,
        "scans_per_sec_steady": round(1.0 / steady.mean(), 2),
        "scans_per_sec_steady_lag1": round(1.0 / steady_l1.mean(), 2),
        "lag1_ate_rmse_m": round(float(a_l1.rmse), 4),
        "scans_per_sec_pipelined": round(1.0 / pipelined, 2),
        "ms_per_scan_p50": round(float(np.percentile(steady, 50)) * 1e3, 2),
        "ms_per_scan_p95": round(float(np.percentile(steady, 95)) * 1e3, 2),
        "ate_rmse_m": round(a.rmse, 4),
        "ate_max_m": round(a.max, 4),
    }


def bench_lio_sharded(frames: int, capacity: int) -> dict:
    """The mp-sharded MAPPING pipeline (pipeline/lio_sharded.py: incremental
    voxel map over 'mp', scans over 'dp') measured end-to-end on the real
    device mesh — on one card that is a (1, 1) mesh, so this row
    validates the distributed program's single-chip cost (the price of the
    shard_map + psum structure vs the plain path is visible against
    ndt_inc_odometry); capacity scaling evidence lives in
    tests/test_map_shard.py (8-device parity with per-shard tables smaller
    than the live map) and scaling_map_shard."""
    jax = _setup_jax()
    import jax.numpy as jnp
    from loc_lib_tpu.io import logdir
    from loc_lib_tpu.ops.pointcloud import PointCloud
    from loc_lib_tpu.pipeline import lio as lio_mod, lio_sharded
    from loc_lib_tpu.models import ndt as ndt_mod
    from loc_lib_tpu.parallel import mesh as mesh_mod
    from loc_lib_tpu.eval import metrics

    log = logdir.make_demo_log(num_frames=frames, capacity=capacity,
                               yaw_rate=0.0, speed=2.0)
    n_dev = jax.device_count()
    mp = n_dev if n_dev > 1 else 1
    mesh = mesh_mod.make_mesh_2d(max(1, n_dev // mp), mp)
    opts = lio_mod.LioOptions(
        matcher="ndt_inc",
        ndt=ndt_mod.NdtOptions(method="incremental", voxel_size=1.0),
        scan_capacity=capacity, with_eskf=True)
    engine = lio_sharded.LioSharded(mesh, opts)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150],
                       log.imu.acce[:150]):
        engine.init_imu(g, a, t)
    assert engine.imu_inited

    warmup = 6
    times, idxs = [], []
    for mg in log.measures(imu_capacity=64):
        scan = PointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                          mask=jnp.asarray(log.scan_mask[mg.scan_index]))
        t0 = time.perf_counter()
        out = engine.add_measure(scan, jnp.asarray(mg.imu_gyro),
                                 jnp.asarray(mg.imu_acce),
                                 jnp.asarray(mg.imu_stamp),
                                 jnp.asarray(mg.imu_valid))
        jax.block_until_ready(out.t)
        times.append(time.perf_counter() - t0)
        idxs.append(mg.scan_index)
    poses = np.stack(engine.poses)
    a = metrics.ate(poses, log.gt_poses[np.asarray(idxs)])
    steady = np.asarray(times[warmup:])
    live = engine.live_voxels_per_shard()
    return {
        "frames": frames,
        "scan_capacity": capacity,
        "mesh": dict(mesh.shape),
        "scans_per_sec_steady": round(1.0 / steady.mean(), 2),
        "ms_per_scan_p50": round(float(np.percentile(steady, 50)) * 1e3, 2),
        "ate_rmse_m": round(a.rmse, 4),
        "live_voxels_per_shard": [int(v) for v in live],
    }


def bench_slam3d_sharded(frames: int, capacity: int) -> dict:
    """DISTRIBUTED SLAM (round 5, VERDICT r4 next #3): loop-closure SLAM
    composed over the mp-SHARDED mapping pipeline
    (pipeline/slam3d_sharded.py) — ScanContext retrieval + loop
    re-registration + two-phase PGO with the accepted correction written
    THROUGH the sharded voxel table (transform + re-bin + re-slab + exact
    merge). On one card the mesh is (1, 1) — the row prices the
    distributed program's structure and the write-through; the 8-device
    parity (live map > one shard's table) is pinned by
    tests/test_map_shard.py::test_slam3d_sharded_closes_loops_over_the_sharded_map."""
    jax = _setup_jax()
    import dataclasses
    import jax.numpy as jnp
    from loc_lib_tpu.io import logdir
    from loc_lib_tpu.ops.pointcloud import PointCloud
    from loc_lib_tpu.pipeline import lio as lio_mod, slam3d
    from loc_lib_tpu.pipeline.slam3d_sharded import Slam3dSharded
    from loc_lib_tpu.models import icp as icp_mod, ndt as ndt_mod
    from loc_lib_tpu.parallel import mesh as mesh_mod
    from loc_lib_tpu.eval import metrics
    from loc_lib_tpu.graph import scan_context as sc

    log = logdir.make_demo_log(num_frames=frames, capacity=capacity,
                               dt=0.2, speed=1.4, yaw_rate=0.72,
                               world_points=60000, extent=16.0,
                               max_range=14.0)
    n_dev = jax.device_count()
    mesh = mesh_mod.make_mesh_2d(max(1, n_dev // n_dev), n_dev)
    opts = slam3d.Slam3dOptions(
        lio=lio_mod.LioOptions(
            matcher="ndt_inc",
            ndt=ndt_mod.NdtOptions(method="incremental", voxel_size=1.0),
            scan_capacity=capacity, with_eskf=True, kf_distance=0.4),
        sc=sc.ScanContextOptions(exclude_recent=8, dist_threshold=0.25),
        loop=slam3d.LoopOptions(min_keyframe_gap=8, max_candidate_dist=10.0,
                                min_effective_pts=60, max_chi2_per_pt=0.1,
                                optimize_every=100, sc_topk=3),
        loop_icp=icp_mod.IcpOptions(method="p2plane_vox", max_iteration=20,
                                    max_plane_distance=0.5, grid_leaf=2.0,
                                    plane_min_pts=4),
    )
    engine = Slam3dSharded(mesh, opts)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150],
                       log.imu.acce[:150]):
        engine.init_imu(g, a, t)

    warmup = 6
    times = []
    for mg in log.measures(imu_capacity=64):
        scan = PointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                          mask=jnp.asarray(log.scan_mask[mg.scan_index]))
        t0 = time.perf_counter()
        engine.add_measure(scan, jnp.asarray(mg.imu_gyro),
                           jnp.asarray(mg.imu_acce),
                           jnp.asarray(mg.imu_stamp),
                           jnp.asarray(mg.imu_valid))
        times.append(time.perf_counter() - t0)

    kf_gt = log.gt_poses[np.asarray(engine.kf_frame)]
    before = metrics.ate(engine.keyframe_poses(), kf_gt)
    t0 = time.perf_counter()
    ran = engine.optimize()
    pgo_s = time.perf_counter() - t0
    after = metrics.ate(engine.keyframe_poses(), kf_gt)
    steady = np.asarray(times[warmup:])
    for th in list(engine._warm_threads.values()):
        th.join(timeout=300)
    return {
        "frames": frames,
        "mesh": dict(mesh.shape),
        "scans_per_sec_steady": round(1.0 / steady.mean(), 2),
        "keyframes": len(engine.kf_R),
        "loops_accepted": len(engine.loops),
        "pgo_ran": bool(ran),
        "pgo_plus_writethrough_s": round(pgo_s, 3),
        "ate_before_pgo_m": round(float(before.rmse), 4),
        "ate_after_pgo_m": round(float(after.rmse), 4),
        "live_voxels_per_shard": engine.live_voxels_per_shard().tolist(),
        "note": "one card = (1,1) mesh: structural cost only; "
                "8-device parity + capacity scaling pinned by "
                "tests/test_map_shard.py",
    }


def bench_loam(frames: int, capacity: int) -> dict:
    """End-to-end LOAM odometry (the row VERDICT r2 flagged as missing):
    ring-annotated scans -> edge/surf curvature extraction -> matcher='loam'
    LIO with the production fused voxel methods (surf=p2plane_vox,
    edge=p2line_vox, the LoamOption defaults). Reference analog: the LOAM
    variant of Lio (lio.cpp:311-410) driven by TestLio."""
    jax = _setup_jax()
    import jax.numpy as jnp
    from loc_lib_tpu.io import logdir, synthetic
    from loc_lib_tpu.ops.pointcloud import PointCloud
    from loc_lib_tpu.pipeline import lio as lio_mod
    from loc_lib_tpu.models import loam as loam_mod
    from loc_lib_tpu.eval import metrics

    log = logdir.make_demo_log(num_frames=frames, capacity=capacity,
                               yaw_rate=0.0, speed=2.0)
    fopts = loam_mod.LoamFeatureOptions(num_scan=16, min_ring_pts=64)
    opts = lio_mod.LioOptions(
        matcher="loam",
        loam=loam_mod.LoamOption(feature=fopts),
        scan_capacity=capacity, with_eskf=True)
    engine = lio_mod.Lio(opts)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150],
                       log.imu.acce[:150]):
        engine.init_imu(g, a, t)
    assert engine.imu_inited

    warmup = 6
    times, idxs, dev_inputs = [], [], []
    state_w = None
    for mg in log.measures(imu_capacity=64):
        pc = PointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                        mask=jnp.asarray(log.scan_mask[mg.scan_index]))
        ringed = synthetic.annotate_rings(pc, num_rings=fopts.num_scan)
        inp = (ringed, jnp.asarray(mg.imu_gyro), jnp.asarray(mg.imu_acce),
               jnp.asarray(mg.imu_stamp), jnp.asarray(mg.imu_valid))
        dev_inputs.append(inp)
        feats = loam_mod.extract_features(ringed, fopts)
        t0 = time.perf_counter()
        out = engine.add_measure(feats.surf, *inp[1:], edge_scan=feats.edge)
        jax.block_until_ready(out.t)
        times.append(time.perf_counter() - t0)
        idxs.append(mg.scan_index)
        if len(dev_inputs) == warmup:
            state_w = engine.state  # post-step snapshot (see bench_lio)
    poses = np.stack(engine.poses)
    a = metrics.ate(poses, log.gt_poses[np.asarray(idxs)])
    steady = np.asarray(times[warmup:])

    # pipelined sustained device rate (the row VERDICT r3 weak #5 flagged as
    # missing): feature extraction + full LIO step per frame, dispatched
    # back-to-back with one final sync — the ring annotation stays outside
    # (it is log preparation; real sensors deliver the ring). Two passes,
    # time the second (dispatch warmup, see bench_lio).
    for _ in range(2):
        st = state_w
        t0 = time.perf_counter()
        for inp in dev_inputs[warmup:]:
            feats = loam_mod.extract_features(inp[0], fopts)
            st, out = lio_mod.step_measure(st, feats.surf, *inp[1:], opts,
                                           edge_scan=feats.edge)
        jax.block_until_ready(out.t)
        pipelined = (time.perf_counter() - t0) / len(dev_inputs[warmup:])
    return {
        "frames": frames,
        "scan_capacity": capacity,
        "scans_per_sec_steady": round(1.0 / steady.mean(), 2),
        "scans_per_sec_pipelined": round(1.0 / pipelined, 2),
        "ms_per_scan_p50": round(float(np.percentile(steady, 50)) * 1e3, 2),
        "ate_rmse_m": round(a.rmse, 4),
        "ate_max_m": round(a.max, 4),
    }


def bench_loc(frames: int, capacity: int,
              icp_method: str = "p2plane_vox") -> dict:
    """Map-based localization (plan: the reference's 200 Hz design point,
    lio_matching_node.cpp:19): scans/s against a prior global map with
    box-crop re-cropping, + ATE. icp_method="p2plane_vox_oct" runs the
    octant-pre-elected variant — Loc is its ideal consumer (the crop
    target is rebuilt rarely and matched hundreds of times, so the 3.4x
    costlier oct build amortizes into a ~4.8x cheaper iteration)."""
    jax = _setup_jax()
    import jax.numpy as jnp
    from loc_lib_tpu.io import logdir, synthetic
    from loc_lib_tpu.ops.pointcloud import PointCloud
    from loc_lib_tpu.pipeline import loc as loc_mod
    from loc_lib_tpu.models import icp as icp_mod
    from loc_lib_tpu.eval import metrics

    log = logdir.make_demo_log(num_frames=frames, capacity=capacity,
                               yaw_rate=0.0, speed=2.0)
    world = synthetic.make_world(num_points=120000, extent=80.0, seed=0)
    opts = loc_mod.LocOptions(scan_capacity=capacity,
                              icp=icp_mod.IcpOptions(method=icp_method))
    engine = loc_mod.Loc(world, opts)
    engine.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3])

    warmup = 4
    times, dev_inputs = [], []
    state_w = None
    for mg in log.measures(imu_capacity=64):
        scan = PointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                          mask=jnp.asarray(log.scan_mask[mg.scan_index]))
        inp = (scan, jnp.asarray(mg.imu_gyro), jnp.asarray(mg.imu_acce),
               jnp.asarray(mg.imu_stamp), jnp.asarray(mg.imu_valid))
        dev_inputs.append(inp)
        if len(dev_inputs) == warmup:
            state_w = engine.state
        t0 = time.perf_counter()
        engine.update_measure(scan, mg.imu_gyro, mg.imu_acce,
                              mg.imu_stamp, mg.imu_valid)
        times.append(time.perf_counter() - t0)
    poses = np.stack(engine.poses)
    a = metrics.ate(poses, log.gt_poses[: len(poses)])
    steady = np.asarray(times[warmup:])

    # sustained device rate: two back-to-back passes over the steady-state
    # frames against a FIXED crop (no host recrop mid-pass), time the 2nd
    # (first pays the per-call dispatch warmup; see bench_lio)
    import jax as jx
    for _ in range(2):
        st = state_w
        t0 = time.perf_counter()
        for inp in dev_inputs[warmup:]:
            st, out = loc_mod.step_measure(st, *inp, opts)
        jx.block_until_ready(out.t)
        pipelined = (time.perf_counter() - t0) / len(dev_inputs[warmup:])
    return {
        "frames": frames,
        "scans_per_sec_steady": round(1.0 / steady.mean(), 2),
        "scans_per_sec_pipelined": round(1.0 / pipelined, 2),
        "ms_per_scan_p50": round(float(np.percentile(steady, 50)) * 1e3, 2),
        "ate_rmse_m": round(a.rmse, 4),
    }


def bench_slam3d(frames: int, capacity: int) -> dict:
    """Loop-closure SLAM on a TWO-LAP circular trajectory: ATE before vs
    after the two-phase PGO from the SAME run (the loop closure's measured
    net benefit — VERDICT r3 weak #2), the solve wall time, and the
    warm-started first-call latency (the r3 27.5 s first-loop compile
    stall now happens in a background thread at init / bucket crossings:
    slam3d.warm_solver)."""
    jax = _setup_jax()
    import jax.numpy as jnp
    from loc_lib_tpu.io import logdir
    from loc_lib_tpu.ops.pointcloud import PointCloud
    from loc_lib_tpu.pipeline import lio as lio_mod, slam3d
    from loc_lib_tpu.models import icp as icp_mod
    from loc_lib_tpu.eval import metrics

    from loc_lib_tpu.graph import scan_context as sc

    # closed circle, lapped TWICE (yaw_rate * dt * frames > 4*pi) so the
    # odometry accumulates a meaningful drift for the PGO to correct
    log = logdir.make_demo_log(num_frames=frames, capacity=capacity,
                               dt=0.2, speed=1.4, yaw_rate=0.72,
                               world_points=60000, extent=16.0,
                               max_range=14.0)
    # production fused paths end-to-end: vox odometry front-end AND vox loop
    # re-registration (VERDICT r2: the benched configs must exercise the
    # production kernels, not the knn+fit oracle); sc_topk=3 exercises the
    # batched multi-candidate registration (icp.scan_match_batch)
    opts = slam3d.Slam3dOptions(
        lio=lio_mod.LioOptions(
            matcher="icp", icp=icp_mod.IcpOptions(method="p2plane_vox"),
            scan_capacity=capacity, with_eskf=True, kf_distance=0.4,
            num_kfs_in_local_map=3),
        sc=sc.ScanContextOptions(exclude_recent=8, dist_threshold=0.25),
        loop=slam3d.LoopOptions(min_keyframe_gap=8, max_candidate_dist=10.0,
                                min_effective_pts=60, max_chi2_per_pt=0.1,
                                optimize_every=100, sc_topk=3),
        loop_icp=icp_mod.IcpOptions(method="p2plane_vox", max_iteration=20,
                                    max_plane_distance=0.5, grid_leaf=2.0,
                                    plane_min_pts=4),
    )
    engine = slam3d.Slam3d(opts)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150],
                       log.imu.acce[:150]):
        engine.init_imu(g, a, t)

    idxs = []
    t_start = time.perf_counter()
    for mg in log.measures(imu_capacity=64):
        scan = PointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                          mask=jnp.asarray(log.scan_mask[mg.scan_index]))
        engine.add_measure(scan, jnp.asarray(mg.imu_gyro),
                           jnp.asarray(mg.imu_acce),
                           jnp.asarray(mg.imu_stamp),
                           jnp.asarray(mg.imu_valid))
        idxs.append(mg.scan_index)
    wall = time.perf_counter() - t_start

    kf_gt = log.gt_poses[np.asarray(engine.kf_frame)]
    before = metrics.ate(engine.keyframe_poses(), kf_gt)
    t0 = time.perf_counter()
    ran = engine.optimize()
    # with warm_start the solver executable was compiled in the background
    # during the run — this is the stall the pipeline actually feels
    pgo_first_s = time.perf_counter() - t0
    after = metrics.ate(engine.keyframe_poses(), kf_gt)
    t0 = time.perf_counter()
    engine.optimize()                        # same graph shape: cached
    pgo_s = time.perf_counter() - t0
    for th in list(engine._warm_threads.values()):
        th.join(timeout=300)  # don't let interpreter exit mid-compile
    return {
        "frames": frames,
        "keyframes": len(engine.kf_R),
        "loops_accepted": len(engine.loops),
        "loop_inliers": (int(engine.loop_inliers.sum())
                         if engine.loop_inliers is not None else 0),
        "pgo_ran": bool(ran),
        "pgo_wall_s": round(pgo_s, 3),
        "pgo_first_call_s": round(pgo_first_s, 3),
        "pgo_warm_compile_s": {str(k): round(v, 2)
                               for k, v in engine.warm_times.items()},
        "ate_before_pgo_m": round(before.rmse, 4),
        "ate_after_pgo_m": round(after.rmse, 4),
        "ate_rmse_m": round(after.rmse, 4),
        "total_wall_s": round(wall, 2),
    }


def _wrap_pi(a: float) -> float:
    return float((a + np.pi) % (2.0 * np.pi) - np.pi)


def bench_mapping2d(frames: int) -> dict:
    """2D submap SLAM (occupancy grid + likelihood-field matching + loop
    closure): scans/s + yaw/translation drift vs the synthetic ground truth
    (the reference's 2D stack, mapping_2d.cpp:65-130, had no numbers).

    Runs the DEVICE-RESIDENT engine (pipeline/mapping2d_device.py, VERDICT
    r3 next #1): one jitted step + one batched pull per scan. The steady
    row includes all host work (loop detection, expansion, PGO); the
    pipelined row is the sustained device rate of the per-scan step chain
    (match + cond keyframe raster/field-regen) dispatched back-to-back —
    the throughput the chip sustains when the host isn't pulling per scan."""
    jax = _setup_jax()
    import jax.numpy as jnp
    from loc_lib_tpu.io import synthetic
    from loc_lib_tpu.pipeline import mapping2d as m2d
    from loc_lib_tpu.pipeline import mapping2d_device as m2dd

    # Full circle in a room where the 12 m lidar always sees orthogonal
    # structure: crosses submap boundaries and returns to the start, so
    # expansion (with previous-submap seeding) and loop closure are actually
    # exercised. (A larger room puts frames in a parallel-wall corridor
    # where cross-track translation is UNOBSERVABLE at this range — that
    # measures the geometry, not the engine.)
    world = synthetic.make_world_2d(extent=10.0, seed=2)
    xy = np.zeros((frames, 720, 2), np.float32)
    valid = np.zeros((frames, 720), bool)
    gt = []
    for k in range(frames):
        a = 2.0 * np.pi * k / frames
        t = np.array([4 * np.cos(a) - 4, 4 * np.sin(a)], np.float32)
        xy[k], valid[k] = synthetic.render_scan_2d(world, a, t, seed=k)
        gt.append((a, t))

    opts = m2d.Mapping2dOptions(max_keyframes_in_submap=16)
    engine = m2dd.Mapping2DDevice(opts)
    warmup = 4
    times, err_t, err_th = [], [], []
    state_w = None
    dev_scans = [(jnp.asarray(xy[k]), jnp.asarray(valid[k]))
                 for k in range(frames)]
    for k in range(frames):
        if k == warmup:
            state_w = engine.dstate
        t0 = time.perf_counter()
        th, t = engine.process_scan(xy[k], valid[k])
        times.append(time.perf_counter() - t0)
        err_t.append(np.linalg.norm(np.asarray(t) - gt[k][1]))
        err_th.append(abs(_wrap_pi(float(th) - gt[k][0])))
    steady = np.asarray(times[warmup:])
    loops_valid = sum(1 for l in engine.loops if l.valid)

    # LAG-1 PIPELINED host loop (round 5): dispatch scan k, pull/handle
    # scan k-1 — the per-scan result pull hides behind device compute,
    # EXACTLY (replay on lifecycle mutation; parity pinned by
    # tests/test_mapping2d.py). Poses arrive one scan late.
    eng_l1 = m2dd.Mapping2DDevice(opts, pipelined=True)
    times_l1 = []
    for k in range(frames):
        t0 = time.perf_counter()
        eng_l1.process_scan(xy[k], valid[k])
        times_l1.append(time.perf_counter() - t0)
    eng_l1.flush()
    steady_l1 = np.asarray(times_l1[warmup:])
    err_l1 = [np.linalg.norm(np.asarray(t) - gt[k][1])
              for k, (_, t) in enumerate(eng_l1.frame_poses)]

    # pipelined device rate: the same steady-state frames dispatched
    # back-to-back with ONE final sync; two passes, time the second
    # (dispatch warmup, see bench_lio)
    for _ in range(2):
        st = state_w
        t0 = time.perf_counter()
        for sx, sv in dev_scans[warmup:]:
            st, out = m2dd.step_scan(st, sx, sv, opts)
        jax.block_until_ready(out.t)
        pipelined = (time.perf_counter() - t0) / len(dev_scans[warmup:])
    return {
        "frames": frames,
        "scans_per_sec_steady": round(1.0 / steady.mean(), 2),
        "scans_per_sec_steady_lag1": round(1.0 / steady_l1.mean(), 2),
        "lag1_replays": eng_l1.replays,
        "lag1_trans_rmse_m": round(
            float(np.sqrt(np.mean(np.square(err_l1)))), 4),
        "scans_per_sec_pipelined": round(1.0 / pipelined, 2),
        "submaps": len(engine.submaps),
        "loops": loops_valid,
        "trans_rmse_m": round(float(np.sqrt(np.mean(np.square(err_t)))), 4),
        "yaw_rmse_rad": round(float(np.sqrt(np.mean(np.square(err_th)))), 4),
    }


def bench_throughput_batched(n_target: int, n_source: int,
                             repeats: int) -> dict:
    """Batched-match throughput (VERDICT r3 weak #3): B independent
    (target, source, init) registrations in ONE program
    (icp.scan_match_batch) at the LOOP-REGISTRATION operating point — the
    batch mode's actual consumer (slam3d sc_topk: keyframe-sized targets,
    a FIXED wide-basin iteration budget; also multi-robot streams and
    offline re-registration sweeps). The scaling rows run a fixed
    iteration count (eps=0) so every lane does identical work — under
    vmap, a batch pays the WORST lane's trip count, so convergence-variant
    lanes measure iteration-count variance, not throughput (measured: B=4
    converged matches from near-perfect inits LOSE to single-stream for
    exactly that reason). A converged B=1 row is kept as the latency
    reference."""
    jax = _setup_jax()
    import jax.numpy as jnp
    from loc_lib_tpu.io import synthetic
    from loc_lib_tpu.models import icp
    from loc_lib_tpu.ops.pointcloud import PointCloud

    world = synthetic.make_world(num_points=200000, extent=80.0, seed=7)
    b_max = 64
    traj = synthetic.make_trajectory(num_frames=b_max + 1, dt=0.1, speed=2.0)
    # the slam3d loop-registration configuration (Slam3dOptions.loop_icp),
    # minus the early exit so all lanes run the same 20 iterations
    opts = icp.IcpOptions(method="p2plane_vox", max_iteration=20,
                          max_plane_distance=0.5, grid_leaf=2.0,
                          bucket_size=8, plane_min_pts=4, eps=0.0)
    rng = np.random.default_rng(3)
    tgts, srcs, R0s, t0s = [], [], [], []
    for b in range(b_max):
        tgts.append(synthetic.render_scan(
            world, traj.R[b], traj.t[b], max_range=70.0,
            max_points=n_target, noise=0.01, seed=2 * b, capacity=n_target))
        srcs.append(synthetic.render_scan(
            world, traj.R[b + 1], traj.t[b + 1], max_range=70.0,
            max_points=n_source, noise=0.01, seed=2 * b + 1,
            capacity=n_source))
        # constant-velocity-grade init (5 cm jitter): the converged sweep
        # needs every lane in the production basin — at 0.15 m some 2048-pt
        # lanes leave it under the default 1 m leaf (measured 0.5 m errors)
        R0s.append(traj.R[b].T @ traj.R[b + 1])
        t0s.append(traj.R[b].T @ (traj.t[b + 1] - traj.t[b])
                   + rng.normal(0.0, 0.05, 3))
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)

    # single-stream reference point: same fixed-iteration workload
    t1 = icp.set_target(tgts[0], opts)
    res = icp.scan_match(t1, opts, srcs[0], jnp.asarray(R0s[0], jnp.float32),
                         jnp.asarray(t0s[0], jnp.float32))
    jax.block_until_ready(res)
    t0 = time.perf_counter()
    for _ in range(repeats):
        res = icp.scan_match(t1, opts, srcs[0],
                             jnp.asarray(R0s[0], jnp.float32),
                             jnp.asarray(t0s[0], jnp.float32))
    jax.block_until_ready(res)
    single = (time.perf_counter() - t0) / repeats

    def sweep(o):
        rows, best = {}, None
        for B in (1, 4, 16, 64):
            try:
                bt = icp.set_target_batch(
                    stack([PointCloud(xyz=t.xyz, mask=t.mask)
                           for t in tgts[:B]]), o)
                bs = stack([PointCloud(xyz=s.xyz, mask=s.mask)
                            for s in srcs[:B]])
                bR = jnp.asarray(np.stack(R0s[:B]), jnp.float32)
                bT = jnp.asarray(np.stack(t0s[:B]), jnp.float32)
                jax.block_until_ready(bt)
                res = icp.scan_match_batch(bt, o, bs, bR, bT)
                jax.block_until_ready(res)
                t0 = time.perf_counter()
                for _ in range(repeats):
                    res = icp.scan_match_batch(bt, o, bs, bR, bT)
                jax.block_until_ready(res)
                dt_call = (time.perf_counter() - t0) / repeats
                t_gt = np.stack([traj.R[b].T @ (traj.t[b + 1] - traj.t[b])
                                 for b in range(B)])
                t_err = float(np.linalg.norm(np.asarray(res.t) - t_gt,
                                             axis=1).max())
                rows[str(B)] = {
                    "ms_per_call": round(dt_call * 1e3, 2),
                    "aggregate_scans_per_sec": round(B / dt_call, 1),
                    "max_trans_err_m": round(t_err, 4),
                }
                # only ACCURATE sweeps feed the headline speedup: a lane
                # outside the basin produces a fast wrong pose
                if t_err < 0.15:
                    best = rows[str(B)]
                del bt, bs, res
            except Exception as e:  # record which B failed, keep the rest
                rows[str(B)] = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
                break
        return rows, best

    # fixed 20 iterations: every lane does identical work — isolates the
    # per-iteration throughput question (answer: compute-bound, flat)
    fixed_rows, fixed_best = sweep(opts)
    # converged mode: lanes stop early, so the per-CALL overhead is a
    # large fraction and batching amortizes it — plus each batched call
    # replaces B dispatch+pull round trips. Options are DENSITY-MATCHED to the 8192-pt
    # keyframe targets (grid_leaf=2.0, plane_min_pts=4): round 4 ran the
    # library defaults (leaf 1.0, min_pts 5), under which only ~23% of
    # source points find a valid plane on a cloud this sparse and the
    # surviving near-zero-residual subset FALSE-CONVERGES at its init —
    # the whole 9.3 cm B=64 tail (VERDICT r4 weak #2; diagnosed round 5,
    # max_trans_err 0.0931 -> 0.0093 with matched density, every lane
    # < 3 cm). The defaults are tuned for the dense 65k-pt LIO local map,
    # not keyframe-sized clouds; IcpOptions.gate_warmup docstring carries
    # the full per-lane diagnosis.
    conv_opts = icp.IcpOptions(method="p2plane_vox", grid_leaf=2.0,
                               plane_min_pts=4)
    t1c = icp.set_target(tgts[0], conv_opts)
    res = icp.scan_match(t1c, conv_opts, srcs[0],
                         jnp.asarray(R0s[0], jnp.float32),
                         jnp.asarray(t0s[0], jnp.float32))
    jax.block_until_ready(res)
    t0 = time.perf_counter()
    for _ in range(repeats):
        res = icp.scan_match(t1c, conv_opts, srcs[0],
                             jnp.asarray(R0s[0], jnp.float32),
                             jnp.asarray(t0s[0], jnp.float32))
    jax.block_until_ready(res)
    single_conv = (time.perf_counter() - t0) / repeats
    conv_rows, conv_best = sweep(conv_opts)
    # ROUND-5: the octant-pre-elected path (p2plane_vox_oct) applied to the
    # BATCHED mode: oct needs ~6x fewer gathered elements per point.
    import dataclasses as _dc
    fixed_oct_rows, _ = sweep(_dc.replace(opts, method="p2plane_vox_oct"))
    conv_oct_rows, conv_oct_best = sweep(
        _dc.replace(conv_opts, method="p2plane_vox_oct"))
    return {
        "backend": jax.default_backend(),
        "n_target": n_target,
        "n_source": n_source,
        "single_stream_scans_per_sec_fixed20": round(1.0 / single, 1),
        "batched_fixed20": fixed_rows,
        "batched_fixed20_oct": fixed_oct_rows,
        "single_stream_scans_per_sec_converged": round(1.0 / single_conv, 1),
        "batched_converged": conv_rows,
        "batched_converged_oct": conv_oct_rows,
        "speedup_converged_best_vs_single": (round(
            conv_best["aggregate_scans_per_sec"] * single_conv, 1)
            if conv_best else None),
        "speedup_converged_oct_best_vs_single": (round(
            conv_oct_best["aggregate_scans_per_sec"] * single_conv, 1)
            if conv_oct_best else None),
    }


def bench_matcher_variants(n_target: int, n_source: int,
                           repeats: int) -> dict:
    """Single-stream matcher variants at the standard operating point:
    exact per-point election (p2plane_vox) vs octant-pre-elected
    correspondences (p2plane_vox_oct) — converged
    scans/s, forced-20-iteration ms/iter, and the pose agreement between
    the two on the same pair."""
    jax = _setup_jax()
    import jax.numpy as jnp
    from loc_lib_tpu.io import synthetic
    from loc_lib_tpu.models import icp

    world = synthetic.make_world(num_points=200000, extent=80.0, seed=7)
    traj = synthetic.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
    tgt = synthetic.render_scan(world, traj.R[0], traj.t[0], max_range=70.0,
                                max_points=n_target, noise=0.01, seed=0,
                                capacity=n_target)
    src = synthetic.render_scan(world, traj.R[1], traj.t[1], max_range=70.0,
                                max_points=n_source, noise=0.01, seed=1,
                                capacity=n_source)
    R0 = jnp.asarray(traj.R[0].T @ traj.R[1], jnp.float32)
    t0v = jnp.asarray(traj.R[0].T @ (traj.t[1] - traj.t[0]), jnp.float32)

    out = {}
    poses = {}
    for meth in ("p2plane_vox", "p2plane_vox_oct"):
        row = {}
        for tag, eps in (("converged", 1e-2), ("iter20", 0.0)):
            opts = icp.IcpOptions(method=meth, eps=eps)
            target = icp.set_target(tgt, opts)
            jax.block_until_ready(target)
            res = icp.scan_match(target, opts, src, R0, t0v)
            jax.block_until_ready(res)
            t0 = time.perf_counter()
            for _ in range(repeats):
                res = icp.scan_match(target, opts, src, R0, t0v)
            jax.block_until_ready(res)
            dt_call = (time.perf_counter() - t0) / repeats
            if tag == "converged":
                row["scans_per_sec"] = round(1.0 / dt_call, 1)
                row["iterations"] = int(res.iterations)
                poses[meth] = np.asarray(res.t)
            else:
                row["ms_per_iter_forced20"] = round(dt_call / 20.0 * 1e3, 3)
        # target build cost (the oct path pays the octant election here)
        opts = icp.IcpOptions(method=meth)
        icp.set_target(tgt, opts)  # warm
        t0 = time.perf_counter()
        target = icp.set_target(tgt, opts)
        jax.block_until_ready(target)
        row["set_target_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        out[meth] = row
    out["pose_delta_m"] = round(
        float(np.linalg.norm(poses["p2plane_vox"]
                             - poses["p2plane_vox_oct"])), 5)
    return out


def bench_throughput_batched_bigmap(repeats: int) -> dict:
    """Batched matching at KEYFRAME-MAP-sized targets (65k points, the
    loop-closing re-registration against full submaps,
    loop_closing.cpp:120-158 analog) — the shape whose direct B>=16
    program can exhaust the compiler's memory.
    `icp.scan_match_batch_chunked` dispatches compilable sub-batches
    sequentially: one executable for any B, bounded compile memory.
    Row = B=8 lanes over chunk=4 at the loop-registration config."""
    jax = _setup_jax()
    import jax.numpy as jnp
    from loc_lib_tpu.io import synthetic
    from loc_lib_tpu.models import icp
    from loc_lib_tpu.ops.pointcloud import PointCloud

    n_target, n_source, B, chunk = 65536, 2048, 8, 4
    world = synthetic.make_world(num_points=400000, extent=80.0, seed=7)
    traj = synthetic.make_trajectory(num_frames=B + 1, dt=0.1, speed=2.0)
    rng = np.random.default_rng(3)
    tgts, srcs, R0s, t0s, gts = [], [], [], [], []
    for b in range(B):
        tgts.append(synthetic.render_scan(
            world, traj.R[b], traj.t[b], max_range=70.0,
            max_points=n_target, noise=0.01, seed=2 * b, capacity=n_target))
        srcs.append(synthetic.render_scan(
            world, traj.R[b + 1], traj.t[b + 1], max_range=70.0,
            max_points=n_source, noise=0.01, seed=2 * b + 1,
            capacity=n_source))
        R0s.append(traj.R[b].T @ traj.R[b + 1])
        gt = traj.R[b].T @ (traj.t[b + 1] - traj.t[b])
        t0s.append(gt + rng.normal(0.0, 0.05, 3))
        gts.append(gt)
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)
    o = icp.IcpOptions(method="p2plane_vox", max_iteration=20,
                       max_plane_distance=0.5, grid_leaf=2.0, bucket_size=8,
                       plane_min_pts=4)
    bt = icp.set_target_batch(
        stack([PointCloud(xyz=t.xyz, mask=t.mask) for t in tgts]), o)
    bs = stack([PointCloud(xyz=s.xyz, mask=s.mask) for s in srcs])
    bR = jnp.asarray(np.stack(R0s), jnp.float32)
    bT = jnp.asarray(np.stack(t0s), jnp.float32)
    jax.block_until_ready(bt)
    out = icp.scan_match_batch_chunked(bt, o, bs, bR, bT, chunk=chunk)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = icp.scan_match_batch_chunked(bt, o, bs, bR, bT, chunk=chunk)
        jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / repeats
    err = np.linalg.norm(np.asarray(out.t) - np.stack(gts), axis=1)
    return {
        "backend": jax.default_backend(),
        "n_target": n_target, "n_source": n_source, "B": B, "chunk": chunk,
        "mode": "converged (eps=1e-2) at the loop-registration config",
        "ms_per_call": round(dt * 1e3, 2),
        "aggregate_scans_per_sec": round(B / dt, 1),
        "max_trans_err_m": round(float(err.max()), 4),
    }


def bench_soak(frames3d: int, frames2d: int) -> dict:
    """LONG-HORIZON soak (VERDICT r4 next #4): the lifecycle paths the
    short benches never stress, measured en route on one multi-lap run
    each for 3D and 2D.

    3D: a ~2.4-lap circuit at 16k-pt scans through full SLAM
    (slam3d: ndt_inc front-end + ScanContext + PGO) with the incremental
    map CAPACITY-BOUND (map_capacity=4096 < the scene's ~8k live voxels)
    so age eviction must fire and stay fired — the reference's 100k-voxel
    LRU bound exercised for real (ndt_registration.cpp:158-171). Records
    live-voxel saturation, eviction pressure, per-lap ATE, loop count,
    sustained rate. The round-5 SO(3)-renormalization fix
    (lie.so3_renormalize) was shaken out by exactly this class of run:
    pre-fix, odometry-only exploration diverged to NaN at frame ~35.

    2D: a multi-lap device-resident run sized to force >= 20 submap
    expansions with an HBM archive budget of 4 (>= 16 host spills),
    loop closures against spilled archives included
    (mapping2d_device.Mapping2DDevice)."""
    jax = _setup_jax()
    import dataclasses
    import jax.numpy as jnp
    from loc_lib_tpu.io import logdir, synthetic
    from loc_lib_tpu.ops.pointcloud import PointCloud
    from loc_lib_tpu.pipeline import lio as lio_mod, slam3d
    from loc_lib_tpu.models import icp as icp_mod, ndt as ndt_mod
    from loc_lib_tpu.eval import metrics
    from loc_lib_tpu.graph import scan_context as sc
    from loc_lib_tpu.ops import voxel as voxel_ops

    out = {}

    # ---- 3D soak -----------------------------------------------------------
    cap = 16384
    log = logdir.make_demo_log(num_frames=frames3d, capacity=cap,
                               dt=0.1, speed=3.0, yaw_rate=0.25,
                               world_points=250000, extent=40.0,
                               max_range=30.0)
    nopts = ndt_mod.NdtOptions(method="incremental", voxel_size=1.0,
                               map_capacity=4096)
    opts = slam3d.Slam3dOptions(
        lio=lio_mod.LioOptions(matcher="ndt_inc", ndt=nopts,
                               scan_capacity=cap, with_eskf=True,
                               kf_distance=0.5),
        sc=sc.ScanContextOptions(exclude_recent=30, dist_threshold=0.25),
        loop=slam3d.LoopOptions(min_keyframe_gap=30, max_candidate_dist=12.0,
                                min_effective_pts=200, max_chi2_per_pt=0.1,
                                optimize_every=8, sc_topk=3),
    )
    eng = slam3d.Slam3d(opts)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150],
                       log.imu.acce[:150]):
        eng.init_imu(g, a, t)

    times, live_trace, err_trace = [], [], []
    lap = int(round(2 * np.pi / (0.25 * 0.1)))
    gt0inv = np.linalg.inv(log.gt_poses[0])
    for mg in log.measures(imu_capacity=64):
        scan = PointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                          mask=jnp.asarray(log.scan_mask[mg.scan_index]))
        t0 = time.perf_counter()
        o = eng.add_measure(scan, jnp.asarray(mg.imu_gyro),
                            jnp.asarray(mg.imu_acce),
                            jnp.asarray(mg.imu_stamp),
                            jnp.asarray(mg.imu_valid))
        times.append(time.perf_counter() - t0)
        k = mg.scan_index
        gt_rel = gt0inv @ log.gt_poses[k]
        err_trace.append(float(np.linalg.norm(
            np.asarray(o.t) - gt_rel[:3, 3])))
        if k % 25 == 0:
            live_trace.append(int(np.sum(np.asarray(
                eng.lio.state.ndt_map.keys) != voxel_ops.INVALID_KEY)))
    eng.optimize()
    for th in list(eng._warm_threads.values()):
        th.join(timeout=300)
    kf_gt = log.gt_poses[np.asarray(eng.kf_frame)]
    ate = metrics.ate(eng.keyframe_poses(), kf_gt)
    steady = np.asarray(times[10:])
    sat = sum(1 for v in live_trace if v >= nopts.map_capacity)
    per_lap = [round(float(np.sqrt(np.mean(
        np.square(err_trace[i * lap:(i + 1) * lap])))), 4)
        for i in range(max(frames3d // lap, 1))
        if err_trace[i * lap:(i + 1) * lap]]
    out["soak3d"] = {
        "frames": frames3d, "scan_capacity": cap, "laps": round(frames3d / lap, 2),
        "map_capacity": nopts.map_capacity,
        "live_voxels_trace": live_trace,
        "capacity_saturated_probes": sat,
        "eviction_fired": bool(sat > 0),
        "keyframes": len(eng.kf_R),
        "loops_accepted": len(eng.loops),
        "scans_per_sec_steady": round(1.0 / steady.mean(), 2),
        "pose_rmse_per_lap_m": per_lap,
        "ate_final_m": round(float(ate.rmse), 4),
        "health": {"frames": eng.lio.health.frames,
                   "total_bad": eng.lio.health.total_bad,
                   "status_final": eng.lio.health.status},
    }

    # ---- 2D soak -----------------------------------------------------------
    from loc_lib_tpu.pipeline import mapping2d, mapping2d_device as m2dd

    world2d = synthetic.make_world_2d(extent=12.0, seed=2)
    mopts = mapping2d.Mapping2dOptions(max_keyframes_in_submap=8,
                                       archived_device_submaps=4,
                                       keyframe_dist=0.25)
    eng2 = m2dd.Mapping2DDevice(mopts)
    errs2, t2 = [], []
    for k in range(frames2d):
        a = 2.0 * np.pi * (k * 3.0 / frames2d)     # three laps
        t = np.array([5 * np.cos(a) - 5, 5 * np.sin(a)], np.float32)
        xy, valid = synthetic.render_scan_2d(world2d, a, t, seed=k)
        t0 = time.perf_counter()
        th, est = eng2.process_scan(xy, valid)
        t2.append(time.perf_counter() - t0)
        errs2.append(float(np.linalg.norm(est - t)))
    spilled = sum(1 for s in eng2.submaps[:-1]
                  if isinstance(s.field, np.ndarray))
    out["soak2d"] = {
        "frames": frames2d,
        "submaps": len(eng2.submaps),
        "archived_spilled_to_host": spilled,
        "loops_valid": sum(1 for l in eng2.loops if l.valid),
        "scans_per_sec_steady": round(1.0 / float(np.mean(t2[10:])), 2),
        "pose_rmse_m": round(float(np.sqrt(np.mean(np.square(errs2)))), 4),
    }
    return out


def bench_scaling_map_shard(n_source: int, repeats: int) -> dict:
    """Scaling evidence for the mp-sharded plane-table path (VERDICT r2
    weak #5): unlike dp source-sharding (compute scales 1/k), map sharding
    buys CAPACITY — per-iteration per-device compute is O(source points)
    with O(1) dense lookups per point, INDEPENDENT of local table size. Two
    measurements establish the projection:

      (a) chip-measured per-iteration time vs TARGET MAP SIZE on one
          device: a flat curve shows a shard holding map/k voxels does the
          same per-iteration work as one holding the whole map, so the only
          scaling cost is the per-iteration `pmin` winner election;
      (b) the pmin budget: 2 arrays x n_source floats per iteration over
          'mp' (candidate distance + winner index). At ICI bandwidth with
          latency margin this is budgeted at 20 us/iteration (conservative;
          8192 floats ~ 32 KB/array).

      projected_efficiency = T_iter / (T_iter + t_pmin) — map-size
      independent, so capacity scales with mp at this flat overhead."""
    jax = _setup_jax()
    import jax.numpy as jnp
    from loc_lib_tpu.io import synthetic
    from loc_lib_tpu.models import icp

    traj = synthetic.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
    opts = icp.IcpOptions(method="p2plane_vox", eps=0.0)  # fixed 20 iters
    eye, z = jnp.eye(3), jnp.zeros(3)

    out_ms = {}
    for world_pts, extent in ((40000, 40.0), (160000, 80.0),
                              (640000, 160.0)):
        world = synthetic.make_world(num_points=world_pts, extent=extent,
                                     seed=7)
        tgt = synthetic.render_scan(world, traj.R[0], traj.t[0],
                                    max_range=extent, max_points=world_pts,
                                    noise=0.01, seed=0, capacity=world_pts)
        src = synthetic.render_scan(world, traj.R[1], traj.t[1],
                                    max_range=extent, max_points=n_source,
                                    noise=0.01, seed=1, capacity=n_source)
        target = icp.set_target(tgt, opts)
        n_vox = int(target.grid.num_voxels)
        res = icp.scan_match(target, opts, src, eye, z)
        jax.block_until_ready(res)
        t0 = time.perf_counter()
        for _ in range(repeats):
            res = icp.scan_match(target, opts, src, eye, z)
        jax.block_until_ready(res)
        ms = (time.perf_counter() - t0) / repeats * 1e3
        out_ms[n_vox] = round(ms, 3)

    ms_vals = list(out_ms.values())
    growth = max(ms_vals) / max(min(ms_vals), 1e-9)
    vox_growth = max(out_ms) / max(min(out_ms), 1)
    # a shard holds map/mp voxels, so its per-iteration time is the SMALL-
    # table point of the curve; the pmin election is the only added cost
    t_iter_us = min(ms_vals) / 20.0 * 1e3
    t_pmin_us = 20.0
    eff = t_iter_us / (t_iter_us + t_pmin_us)
    return {
        "backend": jax.default_backend(),
        "n_source": n_source,
        "ms_per_scan_vs_map_voxels": out_ms,
        "time_growth_vs_voxel_growth": [round(growth, 2),
                                        round(vox_growth, 2)],
        "t_pmin_budget_us_per_iter": t_pmin_us,
        "per_iter_us_small_table": round(t_iter_us, 1),
        "projected_mp_efficiency_pct": round(100.0 * eff, 1),
        "note": "per-device per-iteration time grows only mildly with "
                "table size (HBM gather locality; far sublinear in "
                "voxels): mp-sharding scales CAPACITY at the flat pmin "
                "overhead AND keeps each shard on the fast small-table "
                "point of this curve",
    }


def bench_scaling_cpu_mesh() -> dict:
    """Partition-correctness curve on the virtual CPU mesh (subprocess so the
    platform choice doesn't disturb the main process). NOT a speedup
    measurement — this host has ~2 physical cores."""
    script = r"""
import json, time
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
from loc_lib_tpu.utils import compile_cache
compile_cache.enable()
import numpy as np, jax.numpy as jnp
from loc_lib_tpu.io import synthetic
from loc_lib_tpu.models import icp
from loc_lib_tpu.parallel import mesh as mesh_mod, match as pmatch
world = synthetic.make_world(num_points=40000, extent=60.0, seed=3)
traj = synthetic.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
tgt = synthetic.render_scan(world, traj.R[0], traj.t[0], max_points=8192,
                            noise=0.005, seed=0, capacity=8192)
src = synthetic.render_scan(world, traj.R[1], traj.t[1], max_points=8192,
                            noise=0.005, seed=1, capacity=8192)
opts = icp.IcpOptions(method="p2plane")
target = icp.set_target(tgt, opts)
out = {}
for n in (1, 2, 4, 8):
    m = mesh_mod.make_mesh(n)
    res = pmatch.icp_scan_match(m, target, opts, src, jnp.eye(3), jnp.zeros(3))
    jax.block_until_ready(res)
    t0 = time.perf_counter()
    for _ in range(5):
        res = pmatch.icp_scan_match(m, target, opts, src,
                                    jnp.eye(3), jnp.zeros(3))
    jax.block_until_ready(res)
    out[n] = (time.perf_counter() - t0) / 5

# mp-sharded plane-table path: per-iteration time vs map-shard count
# (partition correctness on the virtual mesh, not hardware speedup)
from loc_lib_tpu.parallel import map_shard
vopts = icp.IcpOptions(method="p2plane_vox", eps=0.0, max_iteration=5)
out_mp = {}
for mp in (1, 2, 4, 8):
    m2 = mesh_mod.make_mesh_2d(1, mp)
    st = map_shard.set_target_sharded(m2, tgt, vopts,
                                      shard_capacity=max(8192 // mp * 2, 2048))
    res = map_shard.icp_scan_match_sharded(m2, st, vopts, src,
                                           jnp.eye(3), jnp.zeros(3))
    jax.block_until_ready(res)
    t0 = time.perf_counter()
    for _ in range(5):
        res = map_shard.icp_scan_match_sharded(m2, st, vopts, src,
                                               jnp.eye(3), jnp.zeros(3))
    jax.block_until_ready(res)
    out_mp[mp] = (time.perf_counter() - t0) / 5
print(json.dumps({
    "WHAT_THIS_IS": "PARTITION-VALIDATION ONLY: virtual 8-device mesh on ~2 "
                    "physical cores. The ms values say the sharded programs "
                    "compile+run at every width, NOT how the algorithm "
                    "scales.",
    "dp_ms_NOT_scaling": {str(k): round(v * 1e3, 2) for k, v in out.items()},
    "mp_ms_NOT_scaling": {str(k): round(v * 1e3, 2) for k, v in out_mp.items()},
}))
"""
    # the child stays off the card: the parent holds it
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))
           or k == "JAX_COMPILATION_CACHE_DIR"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    ms = json.loads(out.stdout.strip().splitlines()[-1])
    ncores = os.cpu_count()
    return {"WHAT_THIS_IS": ms["WHAT_THIS_IS"],
            "ms_per_scan_vs_virtual_devices_NOT_scaling":
                ms["dp_ms_NOT_scaling"],
            "ms_per_scan_vs_map_shards_NOT_scaling": ms["mp_ms_NOT_scaling"],
            "physical_cores": ncores}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small shapes")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "bench_suite.json"))
    ap.add_argument("--only", nargs="*", default=None,
                    help="re-run only these sections, merging into the "
                         "existing artifact")
    args = ap.parse_args()
    _setup_jax()
    from loc_lib_tpu.utils.device import card_line, require_gpu
    dev = require_gpu()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)

    frames = 12 if args.quick else 40
    cap = 2048 if args.quick else 8192

    suite = {"quick": bool(args.quick), "device_kind": dev.device_kind,
             "card": card_line()}
    # `is not None` (not truthiness): `--only` with zero names must still
    # merge-load, not clobber the artifact with a near-empty object
    if args.only is not None and os.path.exists(args.out):
        with open(args.out) as f:
            suite = json.load(f)
    # staleness made visible (VERDICT r2 weak #2): the artifact records the
    # exact commit its numbers were measured at
    try:
        suite["git_sha"] = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=REPO, timeout=10).stdout.strip()
    except Exception:
        suite["git_sha"] = "unknown"
    suite["recorded_at"] = time.strftime("%Y-%m-%d %H:%M:%S")
    for name, fn in [
        ("lio_full_log", lambda: bench_lio("icp", frames, cap)),
        ("lio_full_log_vox",
         lambda: bench_lio("icp", frames, cap, icp_method="p2plane_vox")),
        ("lio_full_log_vox_inc",
         lambda: bench_lio("icp_vox_inc", frames, cap,
                           icp_method="p2plane_vox")),
        ("ndt_inc_odometry", lambda: bench_lio("ndt_inc", frames, cap)),
        ("lio_sharded_mapping", lambda: bench_lio_sharded(frames, cap)),
        ("loam_odometry", lambda: bench_loam(frames, cap)),
        ("loc_matching", lambda: bench_loc(frames, cap)),
        ("loc_matching_oct",
         lambda: bench_loc(frames, cap, icp_method="p2plane_vox_oct")),
        ("mapping2d", lambda: bench_mapping2d(80 if not args.quick else 24)),
        ("slam3d_loop", lambda: bench_slam3d(92, min(cap, 2048))),
        ("slam3d_sharded",
         lambda: bench_slam3d_sharded(64 if not args.quick else 40,
                                      min(cap, 2048))),
        ("matcher_variants",
         lambda: bench_matcher_variants(65536 if not args.quick else 8192,
                                        8192 if not args.quick else 2048,
                                        10 if args.quick else 30)),
        # keyframe-sized targets, scan-sized sources: the re-registration
        # sweep operating point. Measured: batching pays in CONVERGED mode
        # (per-call overhead amortized; 3.8x aggregate at B=64 on this
        # workload) and is compute-bound flat in fixed-iteration mode.
        ("throughput_batched_bigmap",
         lambda: bench_throughput_batched_bigmap(5 if args.quick else 10)),
        ("throughput_batched",
         lambda: bench_throughput_batched(8192, 2048,
                                          5 if args.quick else 20)),
        ("soak", lambda: bench_soak(120 if args.quick else 600,
                                    120 if args.quick else 500)),
        ("scaling_map_shard",
         lambda: bench_scaling_map_shard(8192, 10 if args.quick else 30)),
        ("scaling_cpu_mesh", bench_scaling_cpu_mesh),
    ]:
        if args.only is not None and name not in args.only:
            continue
        t0 = time.perf_counter()
        try:
            suite[name] = fn()
            suite[name]["bench_wall_s"] = round(time.perf_counter() - t0, 1)
            print(f"[suite] {name}: {json.dumps(suite[name])}",
                  file=sys.stderr)
        except Exception as e:  # record the failure, keep the artifact
            suite[name] = {"error": f"{type(e).__name__}: {e}"}
            print(f"[suite] {name} FAILED: {e}", file=sys.stderr)

    with open(args.out, "w") as f:
        json.dump(suite, f, indent=1)
    print(json.dumps({"artifact": args.out,
                      "sections": {k: ("ok" if "error" not in v else "error")
                                   for k, v in suite.items()
                                   if isinstance(v, dict)}}))
    if any(isinstance(v, dict) and "error" in v for v in suite.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
