"""Multi-host entry: `jax.distributed` initialization + global mesh helpers.

The reference's only transport is single-machine ROS pub/sub
(SURVEY.md section 2 "Parallelism & distribution": no MPI/NCCL/multi-node
anything). Here multi-host is first-class: one `init()` call per process
wires the JAX distributed runtime (NVLink inside a host, the network across
hosts),
after which every `shard_map`/`pjit` program in this package — the
distributed matchers (parallel/match.py), the spatially sharded maps
(parallel/map_shard.py), the edge-sharded pose graph (parallel/graph.py) —
runs unchanged over the GLOBAL device set: XLA inserts the cross-host
collectives behind the same `psum`s.

Multi-host tests don't need hardware (SURVEY.md section 4): CPU processes with
gloo collectives simulate hosts — see tests/test_multihost.py, which
spawns N local processes, each `init()`s against a local coordinator, and
checks a global-mesh psum. Nothing tells JAX of a GPU cluster, so pass the
coordinator address, process count and process id (arguments or the
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID variables).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         local_device_count: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime for this process.

    No-op when running single-process (nothing configured and no
    JAX_COORDINATOR_ADDRESS in the environment). Otherwise pass all three
    (or set JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).

    local_device_count: for CPU multi-host simulation, the number of virtual local
    devices this process contributes (sets jax_num_cpu_devices; must happen
    before the backend initializes).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return  # single-process run

    if local_device_count is not None:
        try:
            jax.config.update("jax_num_cpu_devices", local_device_count)
        except RuntimeError:
            # backend already initialized (e.g. an interpreter-startup hook
            # imported jax); honor a pre-set XLA_FLAGS device count instead
            pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def global_mesh(dp: Optional[int] = None, mp: int = 1) -> Mesh:
    """(dp, mp) mesh over ALL global devices (every process sees the same
    mesh). Defaults to dp = device_count / mp. Lay 'mp' innermost so map
    shards of one slab-group sit on one host where possible and the 'dp'
    reduction crosses hosts only once per host."""
    n = jax.device_count()
    if dp is None:
        dp = n // mp
    assert dp * mp <= n, (dp, mp, n)
    devs = np.array(jax.devices()[: dp * mp]).reshape(dp, mp)
    return Mesh(devs, ("dp", "mp"))


def host_local_to_global(mesh: Mesh, spec: P, local: np.ndarray) -> jax.Array:
    """Assemble a globally sharded array from per-process local shards
    (the multi-host replacement for jax.device_put of replicated inputs):
    each process contributes its slice of the leading axis."""
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), local)
