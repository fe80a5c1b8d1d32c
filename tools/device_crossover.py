#!/usr/bin/env python
"""Measure the host-vs-device crossover for the round Schur update
on REAL round workloads: time

  host:    mutual_reduce (ranged C kernel) + eliminate_against_reduced
           (qinv C kernel)            -- the production path
  waves:   ops.sparse_device.eliminate_device (COO waves: expand ->
           sort -> segment-reduce per level)  -- the retired-by-
           measurement r3 design, kept for the comparison table
  onepass: host mutual_reduce + ops.sparse_onepass.eliminate_onepass_device
           (batched per-row merge with XLA's sort; the device analog of
           csrc/schur_mod.c)

on the exact (U, S_rest) pairs the echelonize driver produces at round 0
of the d7 / d8 boundary cases and a dense-ish random case.  Results are
checked equal (exact mod-p) and printed as a table for PERF.md.

Usage: python tools/device_crossover.py [--d8|--d9] [--skip-waves]
(d9 runs minutes on the wave path; the default cases finish in ~1-2 min)
"""

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from spasm_tpu.utils.hostmem import prefault, tune_host_malloc

tune_host_malloc()
prefault(4 << 30)

import spasm_tpu as st  # noqa: E402
from spasm_tpu import elimination as E  # noqa: E402
from spasm_tpu.csr import SparseGFp  # noqa: E402
from spasm_tpu.echelonize import _round_schur_estimate  # noqa: E402
from spasm_tpu.fixtures import simplex_boundary  # noqa: E402
from spasm_tpu.ops.sparse_device import eliminate_device  # noqa: E402
from spasm_tpu.ops.sparse_onepass import eliminate_onepass_device  # noqa: E402
from spasm_tpu.pivots import find_structural_pivots  # noqa: E402


def round0_pair(A):
    """The (Upart, pcols, levels, S_rest) pair of round 0, exactly as the
    driver forms it."""
    f = A.field
    S = A.to_scipy()
    prows, pcols, _ = find_structural_pivots(A)
    est, S_rest, rest_rows, blk = _round_schur_estimate(f, S, prows, pcols)
    Upart, piv_vals, levels = blk
    return Upart, pcols, levels, S_rest


def host_path(f, Upart, pcols, levels, S_rest):
    Ustar, ok = E.mutual_reduce(f, Upart, pcols, levels)
    assert ok
    out, _ = E.eliminate_against_reduced(f, Ustar, pcols, S_rest,
                                         assume_canonical=True)
    return out


def device_path(f, Upart, pcols, levels, S_rest, cap_factor=4):
    U = SparseGFp.from_scipy(Upart, f.p, assume_canonical=True)
    B = SparseGFp.from_scipy(S_rest, f.p, assume_canonical=True)
    return eliminate_device(f, U, pcols, levels, B, cap_factor=cap_factor)


def _csr_equal_scipy(f, D_h, D_other):
    import scipy.sparse as sp

    Dh = SparseGFp.from_scipy(D_h, f.p, assume_canonical=True)
    if isinstance(D_other, SparseGFp):
        Do = D_other
    else:
        Do = SparseGFp.from_scipy(sp.csr_matrix(D_other), f.p,
                                  assume_canonical=True)
    return (Dh.nnz == Do.nnz
            and np.array_equal(Dh.indptr, Do.indptr)
            and np.array_equal(Dh.indices, Do.indices)
            and np.array_equal(Dh.data, Do.data))


def bench_case(name, A, reps=2, skip_waves=False):
    f = A.field
    t0 = time.time()
    Upart, pcols, levels, S_rest = round0_pair(A)
    print(f"[{name}] U {Upart.shape} nnz={Upart.nnz}, "
          f"S_rest {S_rest.shape} nnz={S_rest.nnz}, "
          f"depth={int(levels.max()) + 1}  (setup {time.time()-t0:.1f}s)",
          flush=True)
    host_w = []
    D_h = None
    for _ in range(reps):
        t0 = time.time()
        D_h = host_path(f, Upart, pcols, levels, S_rest)
        host_w.append(time.time() - t0)
    # shared host stage of the one-pass device path (also timed)
    t0 = time.time()
    Ustar, okr = E.mutual_reduce(f, Upart, pcols, levels)
    assert okr
    mreduce_s = time.time() - t0
    import scipy.sparse as sp

    S_sp = sp.csr_matrix(S_rest)
    row = {"case": name, "U_nnz": int(Upart.nnz),
           "S_nnz": int(S_rest.nnz), "depth": int(levels.max()) + 1,
           "host_s": round(min(host_w), 3),
           "mreduce_s": round(mreduce_s, 3)}
    for label in ("onepass_xla",):
        w, stats, D_o = [], {}, None
        for _ in range(reps):
            t0 = time.time()
            D_o = eliminate_onepass_device(f, Ustar, pcols, S_sp,
                                           _stats=stats)
            w.append(time.time() - t0)
            if D_o is None:
                break
        if D_o is None:
            print(f"[{name}] {label}: tile-slot overflow", flush=True)
            row[label + "_s"] = None
            row[label + "_eq"] = None
            continue
        ok = _csr_equal_scipy(f, D_h, D_o)
        print(f"[{name}] {label} {min(w):.2f}s {['%.2f' % x for x in w]} "
              f"stats={stats} equal={ok}", flush=True)
        row[label + "_s"] = round(min(w), 3)
        row[label + "_eq"] = ok
        row[label + "_stats"] = stats
    if not skip_waves:
        dev_w, D_d = [], None
        for r in range(reps):
            t0 = time.time()
            D_d = device_path(f, Upart, pcols, levels, S_rest)
            dev_w.append(time.time() - t0)
            if D_d is None:
                print(f"[{name}] waves: capacity overflow at cap_factor=4")
                break
        ok = _csr_equal_scipy(f, D_h, D_d) if D_d is not None else None
        row["waves_s"] = (round(min(dev_w), 3) if dev_w and D_d is not None
                          else None)
        row["waves_eq"] = ok
    print(f"[{name}] host {min(host_w):.2f}s (mreduce {mreduce_s:.2f}s) | "
          f"onepass_xla {row.get('onepass_xla_s')} | "
          f"waves {row.get('waves_s', 'skipped')}", flush=True)
    return row


def main():
    import jax

    print("backend:", jax.default_backend(), jax.devices()[0])
    skip_waves = "--skip-waves" in sys.argv
    rows = []
    rows.append(bench_case("d7 boundary (2.56M nnz)",
                           simplex_boundary(22, 7), skip_waves=skip_waves))
    f = st.field(42013)
    rng = np.random.default_rng(42)
    rows.append(bench_case("random 30k^2 d=2e-4 (dense-ish rounds)",
                           SparseGFp.rand(f, 30000, 30000, 2e-4, rng),
                           skip_waves=skip_waves))
    if "--d9" in sys.argv:
        rows.append(bench_case("d9 boundary (53.1M nnz)",
                               simplex_boundary(26, 9), reps=1,
                               skip_waves=True))
    elif "--d8" in sys.argv:
        rows.append(bench_case("d8 boundary (28.1M nnz)",
                               simplex_boundary(26, 8), reps=1,
                               skip_waves=True))
    hdr = ("\n| case | U nnz | S nnz | depth | host s | mreduce s | "
           "onepass xla s | waves s | eq |")
    print(hdr)
    print("|" + "---|" * 9)
    for r in rows:
        print(f"| {r['case']} | {r['U_nnz']} | {r['S_nnz']} | "
              f"{r['depth']} | {r['host_s']} | {r['mreduce_s']} | "
              f"{r.get('onepass_xla_s')} | "
              f"{r.get('waves_s', '—')} | {r.get('onepass_xla_eq')} |")


if __name__ == "__main__":
    main()
