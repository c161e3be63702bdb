#!/usr/bin/env python3
"""Drive the main path once on one GPU and check what comes out.

    python chip_smoke.py                  # one card, phases (a)-(f)
    python chip_smoke.py --four           # four cards: sharded Loc and
                                          # mapping vs the single-device run
    python chip_smoke.py --rehearse-cpu   # phases (c)-(f) (or --four's) on
                                          # the CPU; prints ATEs, no result

Phases, in one process and in this order (any failure exits non-zero):

  (a) device: JAX's first device must be a GPU; prints the card's name and
      power limit as nvidia-smi reports them.
  (b) linearization parity at N=8192, S=7: every `ops.linearize` function
      against its float64 formula (`eval.linearize_ref`, tolerance stated
      there), with its steady-state time on the card.
  (c) single match: `icp.scan_match` (p2plane_vox_oct and p2plane_vox) on
      `bench.build_workload()` (65,536-point target, 8,192-point source);
      both must land within 0.5 deg / 3 cm of ground truth.
  (d) mapping: `run_mapping` on a 30-frame demo log of 8,192-point scans,
      with the default matcher and with ndt_inc (65,536-voxel table).
  (e) localization: `run_matching` (p2plane_vox, 150 m box, 131,072-point
      crop of a 120k-point world) on the 20-frame `apps.matching --demo`
      log at 2 m/s, seeded with the first pose and velocity.
  (f) SLAM: `apps.slam --demo`, two laps of a circle at 8,192-point scans
      (LIO + ScanContext + batched loop registration + PGO); must close at
      least one loop through the batched path, and the pose graph must
      move the keyframes.

Each of (d)-(f) must reach an ATE no more than ATE_SLACK_M above the same
phase's CPU ATE (`CPU_ATE_M`, from --rehearse-cpu at the same sizes).

The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import functools
import json
import os
import time

from loc_lib_tpu.utils.device import card_line, require_gpu

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")

SCAN_POINTS = 8192
MAP_FRAMES = 30
LOC_FRAMES = 20
SLAM_FRAMES = 92            # two laps of apps.slam's demo circle
FOUR_FRAMES = 12
ROT_GATE_RAD = 0.0088       # 0.5 deg (bench.PARITY_ROT_RAD)
TRANS_GATE_M = 0.03         # 3 cm (bench.PARITY_TRANS_M)
SHARD_POSE_TOL_M = 0.02     # tests/test_map_shard.py sharded-vs-single bound
ATE_SLACK_M = 0.01
# ATE of each phase on the CPU at the sizes above (--rehearse-cpu)
CPU_ATE_M = {"mapping_icp": 0.0473, "mapping_ndt_inc": 0.0497, "loc": 0.0027,
             "slam_odometry": 0.0508, "slam_keyframes_pgo": 0.0452}


def log(*a):
    print(*a, flush=True)


def memory(jitted, *args, **kw) -> str:
    """compiled.memory_analysis() of `jitted` at these arguments."""
    m = jitted.lower(*args, **kw).compile().memory_analysis()
    if m is None:
        return "memory_analysis: not reported"
    mib = lambda x: f"{x / 2**20:.1f} MiB"
    return (f"memory_analysis: args {mib(m.argument_size_in_bytes)}, "
            f"out {mib(m.output_size_in_bytes)}, "
            f"temp {mib(m.temp_size_in_bytes)}, "
            f"code {mib(m.generated_code_size_in_bytes)}")


def steady_ms(fn, *args, reps=100) -> float:
    """Mean time of one call at steady state, fenced by block_until_ready."""
    import jax
    for _ in range(3):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_linearize(card):
    import jax
    import jax.numpy as jnp
    from loc_lib_tpu.eval import linearize_ref as lr
    from loc_lib_tpu.ops import linearize

    log(f"tolerance (relative): {lr.TOLERANCE}; counts exact")
    for kind in lr.KINDS:
        args, kw = lr.make_case(kind, SCAN_POINTS, seed=1)
        fname, ref = lr.case_fns(kind)
        fn = jax.jit(functools.partial(getattr(linearize, fname), **kw))
        dargs = [jnp.asarray(a) for a in args]
        err = lr.compare(fn(*dargs), ref(*args, **kw))
        ms = steady_ms(fn, *dargs)
        log(f"  {kind:13s} N={SCAN_POINTS} H {err['H']:.2e} b {err['b']:.2e} "
            f"chi2 {err['chi2']:.2e} n {err['n']}/{err['n_ref']}; "
            f"plain {ms:.4f} ms/call [{card}]")
        assert lr.within_tolerance(err), (kind, err)


def phase_single_match(card):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import bench
    from loc_lib_tpu.models import icp

    tgt, src, R_gt, t_gt, R_init, t_init = bench.build_workload()
    R0 = jnp.asarray(R_init, jnp.float32)
    t0 = jnp.asarray(t_init, jnp.float32)
    for method in ("p2plane_vox_oct", "p2plane_vox"):
        opts = icp.IcpOptions(method=method)
        target = jax.block_until_ready(icp.set_target(tgt, opts))
        res = jax.block_until_ready(icp.scan_match(target, opts, src, R0, t0))
        rot = bench._rot_err(np.asarray(res.R, np.float64), R_gt)
        trans = float(np.linalg.norm(np.asarray(res.t, np.float64) - t_gt))
        ms = steady_ms(lambda: icp.scan_match(target, opts, src, R0, t0),
                       reps=20)
        log(f"  {method}: {np.degrees(rot):.4f} deg / {trans * 100:.3f} cm, "
            f"iters {int(res.iterations)}, n_eff {int(res.num_effective)}; "
            f"{ms:.3f} ms/match [{card}]")
        log("    " + memory(icp.scan_match, target, opts, src, R0, t0))
        assert rot < ROT_GATE_RAD and trans < TRANS_GATE_M, (method, rot,
                                                             trans)


def _lio_step_memory(log_, opts):
    import jax.numpy as jnp
    from loc_lib_tpu.ops.pointcloud import PointCloud
    from loc_lib_tpu.pipeline import lio as lio_mod

    mg = next(iter(log_.measures(imu_capacity=64)))
    scan = PointCloud(xyz=jnp.asarray(log_.scan_xyz[mg.scan_index]),
                      mask=jnp.asarray(log_.scan_mask[mg.scan_index]))
    return memory(lio_mod.step_measure, lio_mod.init_state(opts), scan,
                  jnp.asarray(mg.imu_gyro), jnp.asarray(mg.imu_acce),
                  jnp.asarray(mg.imu_stamp), jnp.asarray(mg.imu_valid),
                  opts)


def _check_ate(name, ate, ates):
    ates[name] = ate
    ref = CPU_ATE_M[name]
    log(f"  {name}: ATE {ate} m (CPU {ref} m)")
    assert ate <= ref + ATE_SLACK_M, (name, ate, ref)


def phase_mapping(card, ates):
    from loc_lib_tpu.apps.mapping import run_mapping
    from loc_lib_tpu.io import logdir
    from loc_lib_tpu.pipeline import lio as lio_mod

    log_ = logdir.make_demo_log(num_frames=MAP_FRAMES, capacity=SCAN_POINTS)
    for matcher in ("icp", "ndt_inc"):
        opts = lio_mod.LioOptions(matcher=matcher, scan_capacity=SCAN_POINTS)
        rep = run_mapping(log_, opts, os.path.join(OUT, "mapping_" + matcher))
        log(f"  matcher={matcher}: frames {rep['frames']}, keyframes "
            f"{rep['keyframes']}, map points {rep['map_points']}, "
            f"stage_ms {rep['stage_ms']} [{card}]")
        log("    " + _lio_step_memory(log_, opts))
        _check_ate("mapping_" + matcher, rep["ate_rmse_m"], ates)


def phase_loc(card, ates):
    import jax.numpy as jnp
    from loc_lib_tpu.apps.matching import demo_inputs, run_matching
    from loc_lib_tpu.ops.pointcloud import PointCloud
    from loc_lib_tpu.pipeline import loc as loc_mod

    log_, world, init, v0 = demo_inputs(LOC_FRAMES, SCAN_POINTS)
    opts = loc_mod.LocOptions(scan_capacity=SCAN_POINTS)
    rep = run_matching(log_, world, opts, os.path.join(OUT, "matching"),
                       init_pose=init, init_velocity=v0)
    log(f"  matcher={opts.matcher}/{opts.icp.method}: frames {rep['frames']}, "
        f"stage_ms {rep['stage_ms']} [{card}]")
    eng = loc_mod.Loc(world, opts)
    eng.set_init_pose(init[:3, :3], init[:3, 3], v0)
    mg = next(iter(log_.measures(imu_capacity=64)))
    scan = PointCloud(xyz=jnp.asarray(log_.scan_xyz[mg.scan_index]),
                      mask=jnp.asarray(log_.scan_mask[mg.scan_index]))
    log("    " + memory(loc_mod.step_measure, eng.state, scan,
                        jnp.asarray(mg.imu_gyro), jnp.asarray(mg.imu_acce),
                        jnp.asarray(mg.imu_stamp), jnp.asarray(mg.imu_valid),
                        opts))
    _check_ate("loc", round(rep["ate_rmse_m"], 4), ates)


def phase_slam(card, ates):
    from loc_lib_tpu.apps import slam as slam_app

    out = os.path.join(OUT, "slam")
    slam_app.main(["--demo", "--demo-frames", str(SLAM_FRAMES), "--out", out])
    with open(os.path.join(out, "report.json")) as f:
        rep = json.load(f)
    log(f"  frames {rep['frames']}, keyframes {rep['keyframes']}, loops "
        f"{rep['loops']} ({rep['loop_inliers']} PGO inliers, "
        f"{rep['loop_batches']} batched registrations), PGO moved keyframes "
        f"up to {rep['pgo_max_shift_m']} m, keyframe ATE online "
        f"{rep['kf_ate_online_m']} m -> after PGO {rep['kf_ate_pgo_m']} m, "
        f"stage_ms {rep['stage_ms']} [{card}]")
    log_ = slam_app.demo_log(SLAM_FRAMES)
    log("    " + _lio_step_memory(
        log_, slam_app.demo_options(log_.scan_xyz.shape[1]).lio))
    assert rep["loops"] >= 1 and rep["loop_inliers"] >= 1, rep
    assert rep["loop_batches"] >= 1, rep
    assert rep["pgo_max_shift_m"] > 0.0, rep
    _check_ate("slam_odometry", rep["ate_rmse_m"], ates)
    _check_ate("slam_keyframes_pgo", rep["kf_ate_pgo_m"], ates)


def phase_four(card):
    """Sharded Loc and sharded ndt_inc mapping over four devices against
    the single-device run of each on the same log, frame by frame."""
    import numpy as np
    from loc_lib_tpu.apps.mapping import run_mapping
    from loc_lib_tpu.apps.matching import demo_inputs, run_matching
    from loc_lib_tpu.io import logdir, trajectory
    from loc_lib_tpu.pipeline import lio as lio_mod, loc as loc_mod

    def poses(out):
        return trajectory.load_kitti(os.path.join(out, "trajectory_kitti.txt"))

    def compare(name, run):
        outs = {}
        for shards in (4, 0):
            out = os.path.join(OUT, f"{name}_mp{shards}")
            t0 = time.perf_counter()
            rep = run(out, shards)
            outs[shards] = poses(out)
            log(f"  {name} mp_shards={shards}: frames {rep['frames']}, ATE "
                f"{rep.get('ate_rmse_m')} m, {time.perf_counter() - t0:.1f} s "
                f"incl. compile [{card}]")
        a, b = outs[4], outs[0]
        assert a.shape == b.shape and len(a) >= FOUR_FRAMES - 2, (a.shape,
                                                                  b.shape)
        err = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
        log(f"  {name}: sharded vs single per-frame |dt| max {err.max():.2e} m"
            f" (bound {SHARD_POSE_TOL_M} m)")
        assert err.max() < SHARD_POSE_TOL_M, (name, err)

    log_, world, init, v0 = demo_inputs(FOUR_FRAMES, SCAN_POINTS)
    lopts = loc_mod.LocOptions(scan_capacity=SCAN_POINTS)
    compare("matching", lambda out, k: run_matching(
        log_, world, lopts, out, init_pose=init, mp_shards=k,
        init_velocity=v0))

    mlog = logdir.make_demo_log(num_frames=FOUR_FRAMES, capacity=SCAN_POINTS)
    mopts = lio_mod.LioOptions(matcher="ndt_inc", scan_capacity=SCAN_POINTS)
    compare("mapping_ndt_inc",
            lambda out, k: run_mapping(mlog, mopts, out, mp_shards=k))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device sharded comparison")
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run on the CPU at the same sizes; prints no result")
    args = ap.parse_args(argv)

    import jax
    if args.rehearse_cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 4 if args.four else 1)
    dev = jax.devices()[0] if args.rehearse_cpu else require_gpu()
    from loc_lib_tpu.utils import compile_cache
    log(f"compile cache: {compile_cache.enable()}")
    devices = jax.devices()
    card = card_line()
    log(f"(a) device: platform {dev.platform}, kind {dev.device_kind}, "
        f"count {len(devices)}")
    log(f"card: {card}")
    if args.four and len(devices) != 4:
        raise SystemExit(f"--four needs 4 devices, found {len(devices)}")
    os.makedirs(OUT, exist_ok=True)

    ates = {}
    if args.four:
        phases = [("four: sharded vs single", lambda: phase_four(card))]
    else:
        phases = [("(c) single match", lambda: phase_single_match(card)),
                  ("(d) mapping", lambda: phase_mapping(card, ates)),
                  ("(e) localization", lambda: phase_loc(card, ates)),
                  ("(f) slam", lambda: phase_slam(card, ates))]
        if not args.rehearse_cpu:
            phases.insert(0, ("(b) linearization parity",
                              lambda: phase_linearize(card)))
    for name, fn in phases:
        log(f"== {name}")
        t0 = time.perf_counter()
        fn()
        log(f"   {name}: passed in {time.perf_counter() - t0:.1f} s")

    if args.rehearse_cpu:
        log(f"rehearsal on {dev.platform}: ATE {json.dumps(ates)}")
        return
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
