"""Device-mesh helpers.

The reference is a single-process CPU library with ROS pub/sub as its only
transport (SURVEY.md section 2 "Parallelism & distribution": none). Here
distribution is first-class: a `jax.sharding.Mesh` over the devices, with
point/data parallelism ("dp") for residual fan-out and a map axis ("mp") for
spatial shards of the voxel map / keyframe blocks. The mesh shape follows the
algorithm alone: four H100s of one host are joined all to all by NVLink, so
every device reaches every other at the same rate. Collectives are XLA's
(`psum`, `all_gather`, lowered to NCCL on the GPU).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh_2d(dp: int, mp: int) -> Mesh:
    """2-D mesh: dp x mp (points x map shards)."""
    devs = np.array(jax.devices()[: dp * mp]).reshape(dp, mp)
    return Mesh(devs, ("dp", "mp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Shard the leading (point) dimension across `axis`."""
    return NamedSharding(mesh, P(axis))
