"""Multi-host initialization and mesh construction.

Within a slice the mesh axes ride ICI; across slices/hosts jax inserts DCN
collectives automatically for sharded computations (SURVEY.md section
2.11).  The elimination rounds in sharded.py are topology-agnostic: they
only see the mesh axis, so the same code runs on 1 chip, 1 host, or a
multi-host pod once `initialize()` has been called on every process.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """Bring up the jax.distributed runtime (no-op when single-process).

    Pass the coordinator address, process count and process id
    explicitly: nothing detects a GPU cluster by itself."""
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return jax.process_count(), jax.process_index()


def global_mesh(axis: str = "rows") -> Mesh:
    """1-D mesh over every addressable device in the job (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def host_local_rows(n: int, mesh: Mesh, axis: str = "rows"):
    """The row range [lo, hi) this process owns under even row sharding
    padded to the mesh size."""
    nshards = mesh.shape[axis]
    per = -(-n // nshards)
    # device order in the mesh determines ownership
    my_devs = [i for i, d in enumerate(mesh.devices.flat)
               if d.process_index == jax.process_index()]
    lo = min(my_devs) * per if my_devs else 0
    hi = (max(my_devs) + 1) * per if my_devs else 0
    return lo, min(hi, n)
