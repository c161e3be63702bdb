"""Multi-host pod simulation (VERDICT r1 missing #5): spawn N local CPU
processes, each joining the JAX distributed runtime over gloo collectives,
and run a global-mesh psum + the distributed matcher across processes.
SURVEY.md section 4: pod tests must run on CPU without hardware."""
import os
import socket
import subprocess
import sys
import textwrap

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_WORKER = textwrap.dedent("""
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")

    from loc_lib_tpu.parallel import multihost
    from loc_lib_tpu.utils import compile_cache
    compile_cache.enable()

    multihost.init(local_device_count=2)   # picks up JAX_* env vars
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 4, jax.device_count()
    assert multihost.is_multiprocess()

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    mesh = multihost.global_mesh(dp=2, mp=2)

    # global psum across processes: each of the 4 global devices holds one
    # row [device_row_index]; the dp-sum is the same on every device
    pid = jax.process_index()
    local = np.arange(2 * pid, 2 * pid + 2, dtype=np.float32).reshape(2, 1)
    ga = multihost.host_local_to_global(mesh, P(("dp", "mp")), local)
    total = jax.jit(lambda x: jnp.sum(x), out_shardings=None)(ga)
    np.testing.assert_allclose(np.asarray(total), 6.0)

    # a real library program over the global mesh: distributed plane-table
    # scan match with the map sharded over 'mp' ACROSS the two processes
    from loc_lib_tpu.io import synthetic
    from loc_lib_tpu.models import icp
    from loc_lib_tpu.parallel import map_shard

    world = synthetic.make_world(num_points=20000, extent=30.0, seed=3)
    traj = synthetic.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
    tgt = synthetic.render_scan(world, traj.R[0], traj.t[0], max_points=2048,
                                noise=0.005, seed=0, capacity=2048)
    src = synthetic.render_scan(world, traj.R[1], traj.t[1], max_points=2048,
                                noise=0.005, seed=1, capacity=2048)
    # wide plane gate: the 0.2 m initial offset exceeds the odometry-grade
    # 0.1 m gate on this sparse 2k-point smoke scene
    opts = icp.IcpOptions(method="p2plane_vox", max_iteration=10,
                          plane_min_pts=3, max_plane_distance=0.5)
    st = map_shard.set_target_sharded(mesh, tgt, opts, shard_capacity=2048)
    res = map_shard.icp_scan_match_sharded(mesh, st, opts, src,
                                           jnp.eye(3), jnp.zeros(3))
    t = np.asarray(res.t)
    assert np.isfinite(t).all(), t
    t_rel = traj.R[0].T @ (traj.t[1] - traj.t[0])
    assert np.linalg.norm(t - t_rel) < 0.15, (t, t_rel)
    print(f"proc {pid}: OK t={t}")

    # the FULL sharded-Loc pipeline over the cross-process mesh: box crop
    # partitioned over 'mp' spanning both processes, one measure-group step
    from loc_lib_tpu.ops.pointcloud import PointCloud
    from loc_lib_tpu.pipeline import loc as loc_mod, loc_sharded

    lopts = loc_mod.LocOptions(
        icp=opts, scan_capacity=2048, local_map_capacity=8192,
        box_size=40.0, recrop_margin=10.0)
    eng = loc_sharded.LocSharded(mesh, np.asarray(world, np.float32), lopts,
                                 shard_capacity=4096)
    eng.set_init_pose(np.asarray(traj.R[0]), np.asarray(traj.t[0]))
    gyro = jnp.zeros((8, 3), jnp.float32)
    acce = jnp.tile(jnp.array([0.0, 0.0, 9.81], jnp.float32), (8, 1))
    stamps = jnp.linspace(0.0, 0.07, 8)
    valid = jnp.ones((8,), bool)
    out = eng.update_measure(src, gyro, acce, stamps, valid)
    assert np.isfinite(np.asarray(out.t)).all()
    print(f"proc {pid}: sharded-Loc step OK t={np.asarray(out.t)}")
""")


@pytest.mark.slow
def test_two_process_pod_simulation(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = []
    # The workers own their backend bring-up: no inherited JAX_/XLA_
    # settings.
    env_base = {k: v for k, v in os.environ.items()
                if not k.startswith(("JAX_", "XLA_"))}
    for pid in range(2):
        # The worker selects the CPU and its local device count through
        # jax.config (as conftest.py does).
        env = dict(env_base,
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID=str(pid),
                   PYTHONPATH=os.getcwd())
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=os.getcwd(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-4000:]}"
        assert f"proc {pid}: OK" in out
