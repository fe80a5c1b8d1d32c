#!/usr/bin/env python
"""Mesh sparse-round scaling: wall of the FULL d7
boundary `echelonize(A, mesh=...)` at 1/2/4/8 CPU shards on the SAME path
(one-pass batched merge, class tiles row-sharded over the mesh), with rank
parity against the host loop.

Run with:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/mesh_scaling.py [--small]

Results go to PERF.md.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8")

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from spasm_tpu.utils.hostmem import prefault, tune_host_malloc  # noqa: E402

tune_host_malloc()
prefault(4 << 30)

import numpy as np  # noqa: E402

import jax  # noqa: E402

# force the CPU platform through the config (authoritative over the env
# var) BEFORE the first backend touch
jax.config.update("jax_platforms", "cpu")

from jax.sharding import Mesh  # noqa: E402

import spasm_tpu as st  # noqa: E402
from spasm_tpu.fixtures import simplex_boundary  # noqa: E402


def main():
    from math import comb

    small = "--small" in sys.argv
    n, k = (18, 6) if small else (22, 7)
    A = simplex_boundary(n, k)
    want = comb(n - 1, k)
    print(f"d{k} boundary on {n} vertices: {A.shape}, {A.nnz} nnz, "
          f"rank {want}", flush=True)

    t0 = time.time()
    r_host = st.rank(A)
    host_w = time.time() - t0
    assert r_host == want, r_host
    print(f"host loop: {host_w:.2f}s", flush=True)

    devs = jax.devices()
    rows = []
    for nsh in (1, 2, 4, 8):
        mesh = Mesh(np.array(devs[:nsh]).reshape(nsh), ("rows",))
        walls = []
        for rep in range(2):
            t0 = time.time()
            fact = st.echelonize(A, mesh=mesh)
            walls.append(time.time() - t0)
            assert fact.r == want, (nsh, fact.r)
        print(f"mesh {nsh} shard(s): {min(walls):.2f}s "
              f"{['%.2f' % w for w in walls]}", flush=True)
        rows.append((nsh, min(walls)))
    print("\n| shards | wall s | speedup vs 1 shard |")
    print("|---|---|---|")
    w1 = rows[0][1]
    for nsh, w in rows:
        print(f"| {nsh} | {w:.2f} | {w1 / w:.2f}x |")
    print(f"| host loop | {host_w:.2f} | — |")


if __name__ == "__main__":
    main()
