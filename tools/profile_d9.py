#!/usr/bin/env python
"""Per-step wall profile of the d9 structured rank (the bench headline).

Times the sub-steps inside the round-loop "schur" phase (estimate/split,
mutual_reduce, eliminate_against_reduced) plus pivot search and assembly,
by monkey-patching timers around the elimination entry points.  Run on
the CPU host path (JAX_PLATFORMS=cpu is fine — the d9 rank is
host-kernel-bound end to end).
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import importlib

ech = importlib.import_module("spasm_tpu.echelonize")
elim = importlib.import_module("spasm_tpu.elimination")
piv = importlib.import_module("spasm_tpu.pivots")
from spasm_tpu import rank
from spasm_tpu.fixtures import simplex_boundary

WALLS = {}


def timed(mod, name):
    orig = getattr(mod, name)

    def wrap(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        WALLS[name] = WALLS.get(name, 0.0) + time.perf_counter() - t0
        return out

    setattr(mod, name, wrap)
    return orig


def main():
    from spasm_tpu.utils.hostmem import prefault, tune_host_malloc
    tune_host_malloc()
    prefault(8 << 30)
    n, k = (26, 9) if "--d9" in sys.argv else (26, 8)
    A = simplex_boundary(n, k)
    if "--d9" in sys.argv:
        rank(simplex_boundary(26, 8))  # bench's d8-scale warm-up
    print(f"matrix {A.shape} nnz={A.nnz}", flush=True)

    # echelonize binds these by value (`from .elimination import ...`),
    # so patch echelonize's own globals too
    for mod, name in [
        (elim, "mutual_reduce"),
        (elim, "eliminate_against_reduced"),
        (ech, "_round_schur_estimate"),
        (piv, "find_structural_pivots"),
    ]:
        timed(mod, name)
    ech.mutual_reduce = elim.mutual_reduce
    ech.eliminate_against_reduced = elim.eliminate_against_reduced
    ech.find_structural_pivots = piv.find_structural_pivots
    reps = 3
    for rep in range(reps):
        WALLS.clear()
        t0 = time.perf_counter()
        rk = rank(A)
        wall = time.perf_counter() - t0
        print(f"rep {rep}: rank={rk} wall={wall:.3f}s")
        for kk, v in sorted(WALLS.items(), key=lambda kv: -kv[1]):
            print(f"    {kk:32s} {v:7.3f}s")
        print(f"    {'(unaccounted)':32s} "
              f"{wall - sum(WALLS.values()):7.3f}s")
        print("  phase_stats:", {k2: round(v2, 3) for k2, v2 in
                                 ech.last_phase_stats().items()})


if __name__ == "__main__":
    main()
