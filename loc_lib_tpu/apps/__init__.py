"""Application layer: runnable offline pipelines.

Rebuild of the reference's `slam_demo` package — the ROS nodes
`lio_mapping_node` / `lio_matching_node` (/root/reference/slam_demo/src/
apps/*.cpp) become CLI replay drivers over the npz log format
(loc_lib_tpu.io.logdir):

    python -m loc_lib_tpu.apps.mapping   --log <dir> --out <dir> [--config y.yaml]
    python -m loc_lib_tpu.apps.matching  --log <dir> --map <map> --out <dir>
    python -m loc_lib_tpu.apps.mapping2d --log <dir> --out <dir>

Each accepts `--demo` to synthesize its input log, replacing the
reference's Baidu-pan dataset download (readme.md:17-21).
"""
