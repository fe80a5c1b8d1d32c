#!/usr/bin/env python
"""Two-process jax.distributed demo on the CPU backend: a genuinely
multi-process distributed elimination round (DCN-analog collectives over
TCP), exercising parallel/multihost.py beyond its single-process unit
tests.

Usage (driver): python tools/multihost_demo.py
  — spawns itself twice with process ids 0/1 and checks both agree.
Worker: python tools/multihost_demo.py <pid> <nproc> <port>
"""
import os
import subprocess
import sys


def worker(pid: int, nproc: int, port: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    # distributed init must precede ANY backend-touching jax call —
    # including package imports that configure caches
    import jax

    # the config update is authoritative over the JAX_PLATFORMS env var
    # and does not initialize the backend
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np

    from spasm_tpu.field import field
    from spasm_tpu.parallel import multihost
    from spasm_tpu.parallel.sharded import elimination_round
    nprocs, idx = jax.process_count(), jax.process_index()
    assert nprocs == nproc and idx == pid, (nprocs, idx)
    mesh = multihost.global_mesh()
    ndev = len(jax.devices())
    assert ndev == 4 * nproc, ndev

    f = field(42013)
    rng = np.random.default_rng(0)  # same seed everywhere: same global X
    n, m = 8 * ndev, 128
    X_global = f.rand((n, m), rng).astype(np.int32)
    lo, hi = multihost.host_local_rows(n, mesh)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("rows", None))
    # build the globally-sharded array from host-local shards
    local = jnp.asarray(X_global[lo:hi])
    arrs = [jax.device_put(X_global[i * (n // ndev):(i + 1) * (n // ndev)],
                           d)
            for i, d in enumerate(mesh.devices.flat)
            if d.process_index == jax.process_index()]
    X = jax.make_array_from_single_device_arrays(
        (n, m), sharding, arrs)
    step = jax.jit(lambda x: elimination_round(f, mesh, x, panel=32))
    X2, U, cols, valid, npiv = step(X)
    jax.block_until_ready(X2)
    npiv = int(npiv)
    assert npiv > 0
    # the pivot panel is replicated: every process sees the same U
    u_local = np.asarray(jax.device_get(U))
    cols_l = np.asarray(cols)
    valid_l = np.asarray(valid)
    import hashlib

    h = hashlib.sha256(u_local.tobytes() + cols_l.tobytes()
                       + valid_l.tobytes()).hexdigest()
    print(f"WORKER {pid} npiv={npiv} panel_sha={h[:16]}", flush=True)

    # ---- sparse path: device FL election + sharded sparse Schur +
    # full mesh echelonize, all across the two processes ----
    from spasm_tpu import SparseGFp, echelonize
    from spasm_tpu.elimination import compute_levels, wave_eliminate
    from spasm_tpu.parallel.sparse_sharded import (sharded_fl_election,
                                                   sharded_sparse_eliminate)
    from spasm_tpu.pivots import fl_row_pivots
    from spasm_tpu.solve import rref_of_U
    import scipy.sparse as sp

    rng2 = np.random.default_rng(7)  # same seed: same global matrix
    A = SparseGFp.rand(f, 96, 88, 0.06, rng2)
    er, ec = sharded_fl_election(f, mesh, A)
    hr, hc = fl_row_pivots(A)
    assert np.array_equal(er, hr) and np.array_equal(ec, hc), \
        "distributed election != host FL"
    # sharded sparse Schur update vs the host wave oracle
    npv = er.size
    S = A.to_scipy()
    Up = sp.csr_matrix(S[er])
    vals = np.asarray(Up[np.arange(npv), ec]).ravel()
    row_of = np.repeat(np.arange(npv), np.diff(Up.indptr))
    Up.data = f.normalize(Up.data * f.inv(vals)[row_of])
    U_blk = SparseGFp.from_scipy(Up, f.p)
    levels = compute_levels(U_blk, ec)
    rest = np.setdiff1d(np.arange(A.n), er)
    B = SparseGFp.from_scipy(sp.csr_matrix(S[rest]), f.p)
    got = sharded_sparse_eliminate(f, mesh, U_blk, ec, levels, B)
    want_sp, _ = wave_eliminate(f, U_blk.to_scipy(), ec, levels,
                                B.to_scipy())
    assert got is not None and got == SparseGFp.from_scipy(want_sp, f.p), \
        "sharded sparse Schur != host oracle"
    # one-pass mesh merge (the primary mesh Schur path) across the two
    # processes vs the host qinv oracle
    from spasm_tpu.elimination import (eliminate_against_reduced,
                                       mutual_reduce)
    from spasm_tpu.ops.sparse_onepass import eliminate_onepass_device

    Ustar, okr = mutual_reduce(f, U_blk.to_scipy(), ec, levels)
    assert okr
    Dh, _ = eliminate_against_reduced(f, Ustar, ec, B.to_scipy(),
                                      assume_canonical=True)
    Dd = eliminate_onepass_device(f, Ustar, ec,
                                  sp.csr_matrix(B.to_scipy()),
                                  min_class_rows=0, mesh=mesh)
    Dh2 = sp.csr_matrix(Dh)
    Dh2.sort_indices()
    Dh2.eliminate_zeros()
    assert (Dd is not None and Dd.nnz == Dh2.nnz
            and np.array_equal(Dd.indices, Dh2.indices)
            and np.array_equal(Dd.data, Dh2.data)), \
        "one-pass mesh merge != host oracle"
    # full mesh echelonize: rank + canonical RREF must match the
    # host-only path, and every process must agree
    fact = echelonize(A, mesh=mesh)
    fact_host = echelonize(A)
    assert fact.r == fact_host.r
    R = rref_of_U(fact)
    assert R == rref_of_U(fact_host)
    hs = hashlib.sha256(R.indptr.tobytes() + R.indices.tobytes()
                        + R.data.tobytes()).hexdigest()
    print(f"WORKER {pid} sparse rank={fact.r} rref_sha={hs[:16]}",
          flush=True)


def main():
    if len(sys.argv) == 4:
        worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
        return
    port = 17643
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=480)[0] for p in procs]
    lines = []
    for i, out in enumerate(outs):
        ok = [l for l in out.splitlines() if l.startswith("WORKER")]
        if procs[i].returncode != 0 or len(ok) < 2:
            print(out)
            print(f"process {i} failed rc={procs[i].returncode}")
            sys.exit(1)
        lines.append(ok)
        for line in ok:
            print(line)
    for k, key in ((0, "panel_sha="), (1, "rref_sha=")):
        sha0 = lines[0][k].split(key)[1]
        sha1 = lines[1][k].split(key)[1]
        assert sha0 == sha1, f"processes disagree on {key[:-1]}"
    print("MULTIHOST OK: 2 processes x 4 devices — dense round panels and "
          "sparse-path (election + sharded Schur + echelonize RREF) agree")


if __name__ == "__main__":
    main()
