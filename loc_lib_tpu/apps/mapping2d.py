"""2D mapping app: submap SLAM over a replayed 2D scan log.

Rebuild of the reference's 2D pipeline driver (Mapping2D usage in
/root/reference/LocUtils/src/mapping_2d/mapping_2d.cpp:65-130 driven from a
laser-scan subscriber) over the offline log format: each frame is a padded
(B, 2) sensor-frame endpoint array + validity mask (scans2d.npz). Exports
the stitched occupancy map as npz and the trajectory as TUM.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..io import trajectory
from ..pipeline import mapping2d as m2d
from ..utils import compile_cache


def run_mapping2d(xy: np.ndarray, valid: np.ndarray, stamps: np.ndarray,
                  opts: m2d.Mapping2dOptions, out_dir: str,
                  device_resident: bool = True,
                  warm_start: bool = True) -> dict:
    """device_resident=True (production) runs the one-jitted-step-per-scan
    engine (pipeline/mapping2d_device.py); False runs the host-driven
    reference-shaped twin, kept as its pinned oracle. warm_start=False
    skips the background loop-executable compiles (tests: concurrent
    XLA:CPU compiles can crash)."""
    os.makedirs(out_dir, exist_ok=True)
    if device_resident:
        from ..pipeline.mapping2d_device import Mapping2DDevice
        engine = Mapping2DDevice(opts, num_beams=xy.shape[1],
                                 warm_start=warm_start)
    else:
        engine = m2d.Mapping2D(opts)
    poses2d = []
    for k in range(len(xy)):
        th, t = engine.process_scan(xy[k], valid[k])
        poses2d.append((th, t))

    # SE(2) -> SE(3) on z=0 for the standard writers
    poses = np.tile(np.eye(4, dtype=np.float32), (len(poses2d), 1, 1))
    for k, (th, t) in enumerate(poses2d):
        c, s = np.cos(th), np.sin(th)
        poses[k, :2, :2] = [[c, -s], [s, c]]
        poses[k, :2, 3] = t
    trajectory.save_tum(os.path.join(out_dir, "trajectory_tum.txt"),
                        np.asarray(stamps), poses)
    # global_occupancy() is the one correct source for BOTH engines: the
    # device-resident engine keeps the LIVE submap's grid in device state,
    # not in the host Submap record (pipeline/mapping2d_device.py)
    occ = engine.global_occupancy()
    np.savez(os.path.join(out_dir, "submaps.npz"),
             counts=np.stack([c for c, _, _ in occ]),
             theta_ws=np.asarray([th for _, th, _ in occ]),
             t_ws=np.stack([t for _, _, t in occ]))
    # stitched global occupancy PNG (the reference's ShowGlobalMap OpenCV
    # window, mapping_2d.cpp:186-324, as a run artifact — io/viz.py)
    from ..io import viz
    img = viz.render_occupancy_global(
        occ, resolution=opts.grid.resolution,
        unknown=opts.grid.unknown,
        traj_xy=np.stack([t for _, t in poses2d]) if poses2d else None)
    viz.write_png(os.path.join(out_dir, "occupancy_global.png"), img)
    report = {"frames": len(poses2d), "submaps": len(engine.submaps),
              "loops": len(engine.loops)}
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log", help="log dir containing scans2d.npz")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--demo-frames", type=int, default=40)
    ap.add_argument("--out", default="./mapping2d_out")
    ap.add_argument("--host-driven", action="store_true",
                    help="run the host-driven oracle engine instead of the "
                         "device-resident one")
    args = ap.parse_args(argv)
    compile_cache.enable()

    if args.demo:
        from ..io import synthetic
        world = synthetic.make_world_2d(seed=2)
        n = args.demo_frames
        xy = np.zeros((n, 720, 2), np.float32)
        valid = np.zeros((n, 720), bool)
        stamps = np.arange(n) * 0.1
        for k in range(n):
            a = 0.5 * np.pi * k / n
            t = np.array([6 * np.cos(a) - 6, 6 * np.sin(a)], np.float32)
            xy[k], valid[k] = synthetic.render_scan_2d(world, a, t, seed=k)
    else:
        if not args.log:
            ap.error("--log or --demo required")
        d = np.load(os.path.join(args.log, "scans2d.npz"))
        xy, valid, stamps = d["xy"], d["valid"], d["stamps"]

    report = run_mapping2d(xy, valid, stamps, m2d.Mapping2dOptions(),
                           args.out,
                           device_resident=not args.host_driven)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
