"""Device mesh helpers.

The reference's multi-accelerator story is two FPGA IP cores driven by two
host threads with a statically halved candidate list
(``loop_detector_fpga_parallel.cpp:32-68``).  The generalization is a
1-D ``candidates`` mesh axis over all devices, which follows the
algorithm alone (every card of a host reaches every other at the same
rate), spanning hosts in multi-host runs: loop candidates and
pose-graph edges shard over it; pose solutions are psum/all-gather
replicated.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

AXIS_CANDIDATES = "c"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS_CANDIDATES,))


def to_global(arr, mesh: Mesh, spec: PartitionSpec):
    """Build a global jax.Array from a host-replicated numpy array.

    In multi-process runs a plain numpy argument cannot be auto-sharded
    over non-addressable devices; every process holds the full (identical)
    value and materializes only its addressable shards."""
    arr = np.asarray(arr)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
