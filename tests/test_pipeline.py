"""End-to-end pipeline tests: LIO odometry and map localization on a
synthetic world (standing in for the reference's rosbag demos,
test_node.cpp:104-374)."""
import numpy as np
import jax.numpy as jnp
import pytest

from loc_lib_tpu.io import synthetic
from loc_lib_tpu.pipeline import lio, loc
from loc_lib_tpu.models import icp, ndt


WORLD = synthetic.make_world(num_points=20000, extent=60.0, seed=0)
TRAJ = synthetic.make_trajectory(num_frames=12, dt=0.1, speed=2.0)


def _scans(capacity=2048, n_frames=12, noise=0.005):
    return [
        synthetic.render_scan(WORLD, TRAJ.R[i], TRAJ.t[i], max_range=35.0,
                              max_points=capacity, noise=noise, seed=i,
                              capacity=capacity)
        for i in range(n_frames)
    ]


def _ate(poses, n):
    """Mean translation error vs ground truth over n frames."""
    err = [np.linalg.norm(poses[i][:3, 3] - (TRAJ.t[i] - TRAJ.t[0]) @ TRAJ.R[0])
           for i in range(n)]
    return float(np.mean(err))


def _gt_rel(i):
    """Ground-truth pose of frame i relative to frame 0 (the LIO world)."""
    R0, t0 = TRAJ.R[0], TRAJ.t[0]
    R = R0.T @ TRAJ.R[i]
    t = R0.T @ (TRAJ.t[i] - t0)
    return R, t


@pytest.mark.parametrize("matcher", ["icp", "ndt", "ndt_inc"])
def test_lio_odometry(matcher):
    opts = lio.LioOptions(
        matcher=matcher,
        icp=icp.IcpOptions(method="p2plane", grid_leaf=1.0),
        # 2 m voxels: the sparse synthetic map needs >3 pts per voxel for a
        # valid Gaussian (ndt_registration.cpp:110 strict > gate)
        ndt=ndt.NdtOptions(voxel_size=2.0, map_capacity=16384),
        scan_capacity=2048,
        scan_filter_leaf=0.5,
        map_filter_leaf=0.25,
        num_kfs_in_local_map=5,
        kf_distance=0.3,
        with_eskf=False,
    )
    engine = lio.Lio(opts)
    n = 8
    for i, scan in enumerate(_scans(n_frames=n)):
        filtered = lio.preprocess_scan(opts, scan.xyz, scan.mask)
        out = engine.add_cloud(filtered)
        R_gt, t_gt = _gt_rel(i)
        err = np.linalg.norm(np.asarray(out.t) - t_gt)
        # direct NDT pulls toward voxel centroids on this sparse random-point
        # world (unweighted accumulation, ndt_registration.cpp:425-433), so
        # its gate is looser than the ICP one.
        tol = 0.5 if matcher == "ndt" else 0.3
        assert err < tol, f"frame {i}: {err:.3f} m drift ({matcher})"
    assert len(engine.kf_poses) >= 2


def test_lio_keyframe_ring_buffer():
    """Keyframes past the window capacity must overwrite the oldest slot."""
    opts = lio.LioOptions(matcher="icp", scan_capacity=2048,
                          num_kfs_in_local_map=3, kf_distance=0.1,
                          with_eskf=False)
    engine = lio.Lio(opts)
    for i, scan in enumerate(_scans(n_frames=6)):
        filtered = lio.preprocess_scan(opts, scan.xyz, scan.mask)
        engine.add_cloud(filtered)
    assert int(engine.state.num_kfs) > 3           # wrapped at least once
    assert engine.state.kf_xyz.shape[0] == 3       # fixed window


def test_loc_localization():
    """Map-based localization: init near truth, track the trajectory."""
    opts = loc.LocOptions(
        matcher="icp", icp=icp.IcpOptions(method="p2plane"),
        box_size=100.0, scan_capacity=2048, local_map_capacity=32768,
        with_eskf=False,
    )
    # global map in the world frame
    engine = loc.Loc(WORLD, opts)
    R0, t0 = TRAJ.R[0], TRAJ.t[0]
    engine.set_init_pose(jnp.asarray(R0), jnp.asarray(t0 + 0.2))
    for i, scan in enumerate(_scans(n_frames=8)):
        out = engine.update_cloud(scan)
        err = np.linalg.norm(np.asarray(out.t) - TRAJ.t[i])
        assert err < 0.3, f"frame {i}: localization error {err:.3f} m"


def test_loc_demo_tracks_from_seeded_velocity(tmp_path):
    """The matching demo moves 0.2 m per scan. Seeded with the fix's
    velocity, Loc tracks it. Started at rest, the predicted pose trails
    past the 0.1 m plane gate and Loc does not catch up."""
    from loc_lib_tpu.apps import matching

    log, gmap, init, v0 = matching.demo_inputs(8, capacity=2048)
    np.testing.assert_allclose(np.linalg.norm(v0), 2.0, rtol=1e-2)
    opts = loc.LocOptions(scan_capacity=2048)
    ate = {name: matching.run_matching(
        log, gmap, opts, str(tmp_path / name), init_pose=init,
        init_velocity=v)["ate_rmse_m"]
        for name, v in (("seeded", v0), ("at_rest", None))}
    assert ate["seeded"] < 0.02, ate
    assert ate["at_rest"] > 0.1, ate


def test_lio_with_eskf_imu():
    """LIO + ESKF measure groups (Lio::AddMeasure path) stays on track."""
    opts = lio.LioOptions(
        matcher="icp", icp=icp.IcpOptions(method="p2plane"),
        scan_capacity=2048, num_kfs_in_local_map=5, kf_distance=0.3,
        with_eskf=True,
    )
    engine = lio.Lio(opts)
    stamps, gyro, acce = synthetic.ideal_imu(TRAJ, rate_hz=100.0)
    # static init from a fake stationary prefix
    for k in range(120):
        ts = -1.3 + k * 0.01
        engine.init_imu(np.zeros(3), np.array([0, 0, 9.81]), ts)
    assert engine.imu_inited

    cap = 16
    n = 10
    scans = _scans(n_frames=n)
    errors = []
    prev_t = 0.0
    for i in range(n):
        t_scan = TRAJ.stamps[i]
        sel = (stamps > prev_t) & (stamps <= t_scan) if i else stamps < 0
        g = np.zeros((cap, 3), np.float32)
        a = np.zeros((cap, 3), np.float32)
        ts = np.zeros((cap,), np.float32)
        v = np.zeros((cap,), bool)
        m = int(sel.sum())
        if m:
            g[:m], a[:m], ts[:m], v[:m] = gyro[sel][:cap], acce[sel][:cap], stamps[sel][:cap], True
        filtered = lio.preprocess_scan(opts, scans[i].xyz, scans[i].mask)
        out = engine.add_measure(filtered, jnp.asarray(g), jnp.asarray(a),
                                 jnp.asarray(ts), jnp.asarray(v))
        prev_t = t_scan
        R_gt, t_gt = _gt_rel(i)
        errors.append(np.linalg.norm(np.asarray(out.t) - t_gt))

    # The filter has a velocity cold start (v=0 at init, true speed 2 m/s):
    # error peaks ~0.6 m mid-transient while v converges, then declines.
    # Assert the transient is bounded and the filter recovers.
    assert max(errors) < 0.8, f"transient too large: {errors}"
    assert errors[-1] < 0.45, f"no recovery: {errors}"
    v = np.asarray(engine.state.eskf.v)
    assert abs(np.linalg.norm(v) - 2.0) < 0.5, f"velocity not learned: {v}"


def test_tracking_health_monitor():
    """System-level failure detection (SURVEY.md section 5: the reference
    has none): good frames keep OK, consecutive bad frames escalate to
    DEGRADED then LOST, recovery resets."""
    from loc_lib_tpu.utils.health import TrackingHealth, HealthOptions
    h = TrackingHealth(HealthOptions(min_effective=100, degrade_after=2,
                                     lost_after=4))
    assert h.update(True, 5000, 10.0) == h.OK
    assert h.update(True, 5000, 10.0) == h.OK
    assert h.update(False, 5000, 10.0) == h.OK          # 1 bad
    assert h.update(True, 50, 1.0) == h.DEGRADED        # 2 bad (n_eff low)
    assert h.update(True, 5000, 1e6) == h.DEGRADED      # 3 bad (chi2/pt)
    assert h.update(False, 0, 0.0) == h.LOST            # 4 bad
    assert h.needs_reinit
    h.reset()
    assert h.status == h.OK
    # a good frame interleaved resets the consecutive counter
    h.update(False, 0, 0.0)
    h.update(True, 5000, 10.0)
    assert h.consecutive_bad == 0 and h.total_bad == 5


def test_loc_health_flags_lost_on_empty_map():
    """Localizing against an empty map must flag LOST, not silently emit
    poses."""
    import numpy as np
    from loc_lib_tpu.pipeline import loc as loc_mod
    from loc_lib_tpu.ops.pointcloud import PointCloud
    rng = np.random.default_rng(0)
    engine = loc_mod.Loc(np.zeros((0, 3), np.float32),
                         loc_mod.LocOptions(scan_capacity=256,
                                            local_map_capacity=1024))
    engine.set_init_pose(np.eye(3), np.zeros(3))
    scan = PointCloud(
        xyz=jnp.asarray(rng.uniform(-5, 5, (256, 3)).astype(np.float32)),
        mask=jnp.ones((256,), bool))
    for _ in range(12):
        engine.update_cloud(scan)
    assert engine.health.needs_reinit


def _pillar_corridor(rng, x_lo=-8.0, x_hi=46.0):
    """Corridor world with x-constraining pillars every 3 m (a featureless
    corridor is x-degenerate for every matcher by design)."""
    L = 6000
    parts = [
        np.stack([rng.uniform(x_lo, x_hi, L), rng.uniform(-4, 4, L),
                  np.zeros(L)], 1),
        np.stack([rng.uniform(x_lo, x_hi, L // 2), np.full(L // 2, -4.0),
                  rng.uniform(0, 3, L // 2)], 1),
        np.stack([rng.uniform(x_lo, x_hi, L // 2), np.full(L // 2, 4.0),
                  rng.uniform(0, 3, L // 2)], 1)]
    for px in np.arange(x_lo + 2, x_hi, 3.0):
        py = rng.uniform(-3.5, 3.5)
        parts.append(np.stack(
            [np.full(240, px) + 0.05 * rng.standard_normal(240),
             py + rng.uniform(-0.3, 0.3, 240),
             rng.uniform(0, 3, 240)], 1))
    return np.concatenate(parts).astype(np.float32)


def _corridor_scan(world, t, rng, capacity=6144):
    near = world[np.abs(world[:, 0] - t[0]) < 8.0]
    pts = (near - t + 0.003 * rng.standard_normal(near.shape))
    from loc_lib_tpu.ops import pointcloud
    return pointcloud.from_numpy(pts.astype(np.float32), capacity=capacity)


@pytest.mark.slow
def test_lio_exploring_odometry_stays_on_manifold():
    """REGRESSION (round 5): odometry-only LIO on an EXPLORING trajectory.

    Before the matcher-output SO(3) projection (lie.so3_renormalize), the
    float32 retraction defect fed back through the constant-velocity
    prediction R*last^-1*R and grew ~2.4x per frame: orthonormality error
    7e-9 at frame 8 -> 0.11 at frame 27 -> solver divergence -> NaN poses
    by frame 36 on exactly this workload. Every circular bench log masked
    it (the ESKF nominal path and short horizons never compounded the
    defect)."""
    rng = np.random.default_rng(0)
    world = _pillar_corridor(rng)
    eng = lio.Lio(lio.LioOptions(with_eskf=False, kf_distance=0.4,
                                 matcher="ndt_inc"))
    z = np.zeros((4, 3), np.float32)
    s = np.zeros(4)
    v = np.zeros(4, bool)
    errs = []
    for k in range(45):
        t = np.array([0.45 * k, 0.0, 0.0], np.float32)
        out = eng.add_measure(_corridor_scan(world, t, rng), z, z, s, v)
        errs.append(np.linalg.norm(np.asarray(out.t) - t))
    R = np.asarray(eng.state.R)
    assert np.abs(R.T @ R - np.eye(3)).max() < 1e-5
    assert max(errs) < 0.1, max(errs)


def test_health_monitor_calibrated_for_ndt_residuals():
    """REGRESSION (round-5 soak finding): the NDT matchers report an
    info-WEIGHTED chi2 (Mahalanobis^2 per residual, outlier gate 20), so
    under the metric 1.0 m^2 default every healthy frame flagged bad and
    the monitor sat at LOST through an entire 0.07 m-ATE soak run. Lio
    must pick the matcher-aware threshold: a clean ndt_inc run stays
    'ok' with (near-)zero bad frames."""
    opts = lio.LioOptions(
        matcher="ndt_inc",
        ndt=ndt.NdtOptions(method="incremental", voxel_size=1.0),
        scan_capacity=2048, with_eskf=False, kf_distance=0.4)
    eng = lio.Lio(opts)
    scans = _scans(capacity=2048, n_frames=8)
    for k in range(8):
        eng.add_cloud(scans[k])
    assert eng.health.status == eng.health.OK, (
        eng.health.status, eng.health.total_bad, eng.health.frames)
    assert eng.health.total_bad <= 1, eng.health.total_bad


def test_lio_pipelined_lag1_matches_sequential():
    """Lio(pipelined=True) (round 5): lag-1 result pulls must leave the
    pose chain identical to sequential mode (the whole per-scan flow is
    one jitted step; the host record feeds nothing back)."""
    opts = lio.LioOptions(matcher="icp",
                          icp=icp.IcpOptions(method="p2plane_vox"),
                          scan_capacity=2048, with_eskf=False,
                          kf_distance=0.4)
    seq = lio.Lio(opts)
    pip = lio.Lio(opts, pipelined=True)
    scans = _scans(capacity=2048, n_frames=8)
    for k in range(8):
        seq.add_cloud(scans[k])
        out_prev = pip.add_cloud(scans[k])
        assert (out_prev is None) == (k == 0)
    pip.flush()
    np.testing.assert_array_equal(np.stack(seq.poses), np.stack(pip.poses))
    assert len(seq.kf_poses) == len(pip.kf_poses)
