"""Multi-host initialization and mesh construction.

The reference has no distributed backend (SURVEY.md §2: no MPI/NCCL);
the JAX equivalent is `jax.distributed` per host plus XLA collectives
emitted from the shard_map programs in `sharded.py` (NCCL on GPUs).
This module is the thin control-plane layer:

* `init_multihost()` — call once per host process before any jax op
  (reads the standard coordinator env vars, or takes them directly);
* `solver_mesh()` — builds the 1-D device mesh with the block axis
  over all global devices.  The GPUs of one host reach each other all
  to all (NVLink), so device order does not matter for it.

Single-host/single-chip runs need none of this; everything degrades
to the local-device path.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for a multi-process run.

    Pass the coordinator address, process count and process id, or
    set the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID env vars (JAX's own cluster detection finds no
    cluster on a plain GPU host).  Safe to call once per process.
    """
    import jax

    kwargs = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs["coordinator_address"] = (
            coordinator_address
            or os.environ["JAX_COORDINATOR_ADDRESS"])
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def solver_mesh(n_devices: Optional[int] = None):
    """Mesh over global devices with the cone-block axis "blk".

    In a multi-process run, `jax.devices()` returns the global device
    list; sharded arrays are created with
    `jax.make_array_from_process_local_data` or device_put with a
    NamedSharding over this mesh (see sharded.shard_bucket_axis).
    """
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("blk",))
