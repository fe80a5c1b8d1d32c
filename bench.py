#!/usr/bin/env python
"""Headline benchmark, matching BASELINE.json's metric ("Schur-update nnz/s
per chip + wall-clock rank time on GL7d/relat matrices"): exact rank of the
GL7d-class structured case — the d9 simplex boundary matrix on 26 vertices
(5,311,735 x 3,124,550, 53.1M nnz; the same size class as GL7d17) — through
the public API on whatever jax backend is present (the GPU under the
driver).  The detail payload carries the other BASELINE configs:

  flagship        the random 10k x 10k case (metric-capped: an
                  effectively full-rank random 10k rank costs ~n^3/3 field
                  ops for ANY exact method, so its nnz/s saturates near
                  ~300k at light speed)
  structured      the d7 boundary case (2.56M nnz)
  structured_large the d9 headline case, with per-phase host/device wall
                  attribution (echelonize.last_phase_stats)
  structured_xl   one size up (d10, 85M nnz) — scaling evidence past the
                  GL7d class
  kernel_basis    kernel (null-space) basis of the d9 matrix itself
                  (1,081,575 kernel rows)
  large_prime     end-to-end rank at p = 2147483629 (tier-B arithmetic)
  dense_rref      at-size 2048^2 device dense RREF walls for tier-B
                  (p = 2147483629) and tier-C (p = 4294967291)
  certificate     d9 rank-certificate create (includes its L-recording
                  echelonize) and O(nnz) verify walls
  device_flagship end-to-end rank dominated by the device dense finish
                  (8192^2 d=0.02; device_share from phase attribution)
  mfu             achieved / peak int8 utilization of the device for the
                  mod-p matmul at 4096^3 and the 4096^2 dense RREF
  structured_large_prime  d7-scale boundary rank at tier-B/C primes +
                  a >= 1M-nnz tier-B kernel basis (reduce_each=1 kernels)
  irregular       rank of a random-subcomplex boundary (non-uniform
                  row/column weights, GL7d/relat stand-in)

Prints the device identity (platform, device_kind, device count, and
nvidia-smi's name and power limit) on one line, then ONE JSON line:
  {"metric": ..., "value": nnz/s, "unit": "nnz/s", "vs_baseline": ratio,
   "device": {...}, "detail": {...}}

Measurement protocol: every case runs >= 2 reps; the BEST wall is the
reported number and the full runs_s list plus the median are in the detail
payload (the first rep of a process can pay first-touch page faults and
compile costs — runs_s makes the cold-run variance auditable, median_s
summarizes it).  The warm-up phase runs a small end-to-end rank and a
d8-scale (28.1M nnz) structured rank so the d9 headline's first rep runs
on a warmed malloc high-water mark and hot code paths.  One-time jit
compiles persist across processes (jax_compilation_cache_dir), so
steady-state reps measure pure execution.

vs_baseline normalizes against BASELINE.md's north-star target (10x an
ESTIMATED 1e6 nnz/s SpaSM single-core rate => 1.0 means target met).  The
reference publishes no numbers of its own (BASELINE.md), and its CLI tools
are not available in this environment to measure directly.
"""

import json
import statistics
import sys
import time
from math import comb

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from spasm_tpu.utils.hostmem import prefault, tune_host_malloc

# first-touch page faults can be far slower than warm pages; keep glibc
# from munmapping large temporaries so they stay warm (utils/hostmem.py)
tune_host_malloc()

import importlib

import spasm_tpu as st

# the package rebinds the name `spasm_tpu.echelonize` to the function;
# importlib gets the module (for last_phase_stats)
_ech_mod = importlib.import_module("spasm_tpu.echelonize")
from spasm_tpu.fixtures import simplex_boundary
from spasm_tpu.ops import dense as dense_ops

N = 10_000
DENSITY = 1e-3
SEED = 20240816
TARGET_NNZ_PER_S = 10e6  # north-star: 10x est. 1M nnz/s single-core SpaSM
BOUNDARY_N, BOUNDARY_K = 22, 7  # 319770 x 170544, 2.56M nnz, rank C(21,7)
# d9-scale case (GL7d-class size): 5,311,735 x 3,124,550, 53.1M nnz
LARGE_N, LARGE_K = 26, 9
LARGE_PRIME_B = 2147483629   # tier-B (near 2^31)
LARGE_PRIME_C = 4294967291   # tier-C (near 2^32)


# int8 dense peak (TOP/s) by jax device_kind: NVIDIA H100 SXM data sheet
# (dense, no sparsity, at the full 700 W power limit)
INT8_PEAK_TOPS = {"NVIDIA H100 80GB HBM3": 1979.0}


def device_identity() -> dict:
    """Platform, device_kind and count as JAX reports them, plus the
    card's name and power limit from nvidia-smi."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def timed_reps(fn, reps):
    """(best, runs, last_result) over `reps` calls of fn."""
    runs, out = [], None
    for _ in range(reps):
        t0 = time.time()
        out = fn()
        runs.append(round(time.time() - t0, 3))
    return min(runs), runs, out


def main():
    # fault the expected peak host footprint up front (parallel touches
    # beat the serial mid-run fault path) so measured phases run on warm
    # pages
    prefault(8 << 30)
    f = st.field(42013)
    rng = np.random.default_rng(SEED)
    A = st.SparseGFp.rand(f, N, N, DENSITY, rng)
    device = device_identity()
    print(json.dumps({"device": device}), flush=True)
    if device["kind"] not in INT8_PEAK_TOPS:
        raise SystemExit(f"no int8 peak on record for {device['kind']!r}")

    # warm-up: a small instance (one-time jit compiles, persistently
    # cached), then one throwaway d8-scale structured rank so the d9
    # headline's first rep runs the real code paths on a warmed malloc
    # high-water mark
    st.rank(st.SparseGFp.rand(f, 512, 512, DENSITY * 4, rng))
    st.rank(simplex_boundary(LARGE_N, 8))  # 3.1M x 1.6M, 28.1M nnz

    wall, runs, r = timed_reps(lambda: st.rank(A), 3)
    value = A.nnz / wall

    B = simplex_boundary(BOUNDARY_N, BOUNDARY_K)
    wall_b, runs_b, rb = timed_reps(lambda: st.rank(B), 3)
    assert rb == comb(BOUNDARY_N - 1, BOUNDARY_K), rb

    # d9-scale structured case: 53M nnz, the reference's GL7d-class size.
    # Per-phase host/device attribution captured from the BEST rep.
    C = simplex_boundary(LARGE_N, LARGE_K)
    runs_c, phases, rc = [], {}, None
    for _ in range(3):
        t0 = time.time()
        rc = st.rank(C)
        dt = round(time.time() - t0, 3)
        if not runs_c or dt < min(runs_c):
            phases = _ech_mod.last_phase_stats()
        runs_c.append(dt)
    wall_c = min(runs_c)
    assert rc == comb(LARGE_N - 1, LARGE_K), rc
    large_detail = {
        "case": f"simplex boundary d{LARGE_K} on {LARGE_N} vertices",
        "shape": list(C.shape), "nnz": C.nnz, "rank": rc,
        "wall_s": wall_c, "runs_s": runs_c,
        "median_s": round(statistics.median(runs_c), 3),
        "nnz_per_s": round(C.nnz / wall_c, 1),
        "phases": phases,
    }

    # one size up (d10: 85M nnz, 7.7M x 5.3M) — scaling evidence past the
    # GL7d class; 2 reps to bound the bench wall
    XL = simplex_boundary(LARGE_N, LARGE_K + 1)
    wall_x, runs_x, rx = timed_reps(lambda: st.rank(XL), 2)
    assert rx == comb(LARGE_N - 1, LARGE_K + 1), rx
    xl_detail = {
        "case": f"simplex boundary d{LARGE_K + 1} on {LARGE_N} vertices",
        "shape": list(XL.shape), "nnz": XL.nnz, "rank": rx,
        "wall_s": wall_x, "runs_s": runs_x,
        "nnz_per_s": round(XL.nnz / wall_x, 1),
    }
    del XL

    # kernel (null-space) basis of the d9 matrix itself
    wall_k, runs_k, K = timed_reps(lambda: st.kernel(C), 2)
    assert K.shape == (C.shape[1] - rc, C.shape[1])
    kernel_detail = {
        "case": f"kernel basis, simplex boundary d{LARGE_K} on "
                f"{LARGE_N} vertices",
        "shape": list(C.shape), "nnz": C.nnz,
        "kernel_rows": K.shape[0], "kernel_nnz": K.nnz,
        "wall_s": wall_k, "runs_s": runs_k,
        "median_s": round(statistics.median(runs_k), 3),
    }

    # end-to-end large-prime rank (tier-B arithmetic end to end)
    fB = st.field(LARGE_PRIME_B)
    G = st.SparseGFp.rand(fB, 1024, 1024, 0.01, np.random.default_rng(1))
    wall_lp, runs_lp, r_lp = timed_reps(lambda: st.rank(G), 2)
    large_prime_detail = {
        "case": f"rank 1024x1024 d=0.01 mod {LARGE_PRIME_B}",
        "nnz": G.nnz, "rank": r_lp, "wall_s": wall_lp, "runs_s": runs_lp,
    }

    # at-size dense RREF walls across the upper prime tiers (the FFPACK
    # replacement; tier-A small-prime speed is implied by the flagship's
    # dense finish)
    dense_detail = {}
    for tier, p in (("tier_b", LARGE_PRIME_B), ("tier_c", LARGE_PRIME_C)):
        fp = st.field(p)
        X = fp.rand((2048, 2048), np.random.default_rng(2)).astype(np.int64)
        wall_d, runs_d, out = timed_reps(lambda: dense_ops.rref(fp, X), 2)
        dense_detail[tier] = {"p": p, "shape": [2048, 2048],
                              "rank": out["rank"], "wall_s": wall_d,
                              "runs_s": runs_d}

    # device flagship: an end-to-end rank whose wall is dominated by the
    # device dense finish — a dense-ish random case harvests almost no
    # structural pivots at round 0, so nearly the WHOLE matrix goes
    # through the fused device finish (the accelerator finish gate,
    # thresh_fin = device_sparsity_threshold).  8192^2 so the device stage
    # dominates the warm wall.  device_share from the same phase
    # attribution as the headline.
    DF = st.SparseGFp.rand(f, 8192, 8192, 0.02, np.random.default_rng(5))
    runs_df, df_phases, r_df = [], {}, None
    for _ in range(2):
        t0 = time.time()
        r_df = st.rank(DF)
        dt = round(time.time() - t0, 3)
        if not runs_df or dt < min(runs_df):
            df_phases = _ech_mod.last_phase_stats()
        runs_df.append(dt)
    device_flagship_detail = {
        "case": "rank 8192x8192 d=0.02 mod 42013 (device dense finish)",
        "nnz": DF.nnz, "rank": r_df, "wall_s": min(runs_df),
        "runs_s": runs_df, "phases": df_phases,
        "device_share": df_phases.get("device_share"),
    }
    del DF

    # MFU: achieved fraction of the device's int8 peak for (a) the mod-p
    # matmul at 4096^3 and (b) the 4096^2 tier-A dense RREF (the
    # FFPACK-replacement at size).  Raw int8 ops = logical mod-p MACs x
    # nl^2 limb products (field.num_limbs).
    import jax
    import jax.numpy as jnp

    from spasm_tpu.field import num_limbs
    from spasm_tpu.ops.matmul import modmatmul

    peak_tops = INT8_PEAK_TOPS[device["kind"]]
    nmm = 4096
    KCHAIN = 16  # single-dispatch chain of dependent matmuls
    rng_m = np.random.default_rng(6)
    a_d = jnp.asarray(f.rand((nmm, nmm), rng_m).astype(np.int32))
    b_d = jnp.asarray(f.rand((nmm, nmm), rng_m).astype(np.int32))

    @jax.jit
    def mm_chain(x, y):
        return jax.lax.fori_loop(
            0, KCHAIN, lambda i, c: modmatmul(f, c, y), x)

    jax.block_until_ready(mm_chain(a_d, b_d))  # compile + warm
    mm_walls = []
    for _ in range(3):
        t0 = time.time()
        jax.block_until_ready(mm_chain(a_d, b_d))
        mm_walls.append((time.time() - t0) / KCHAIN)
    wall_mm = min(mm_walls)
    nl = num_limbs(f.p)
    logical_tops = 2 * nmm**3 / wall_mm / 1e12
    raw_int8_tops = logical_tops * nl * nl
    del a_d, b_d
    X4 = f.rand((4096, 4096), np.random.default_rng(7)).astype(np.int64)
    wall_r4, runs_r4, out4 = timed_reps(lambda: dense_ops.rref(f, X4), 2)
    rref_mac_per_s = 4096**3 / wall_r4
    mfu_detail = {
        "int8_peak_tops": peak_tops,
        "modmatmul_4096": {
            "p": f.p, "limbs": nl, "chain_len": KCHAIN,
            "wall_s_per_matmul": round(wall_mm, 5),
            "runs_s_per_matmul": [round(w, 5) for w in mm_walls],
            "logical_modp_tops": round(logical_tops, 2),
            "raw_int8_tops": round(raw_int8_tops, 2),
            "mfu": round(raw_int8_tops / peak_tops, 4),
        },
        "dense_rref_4096": {
            "p": f.p, "rank": out4["rank"], "wall_s": wall_r4,
            "runs_s": runs_r4,
            "logical_mac_per_s": round(rref_mac_per_s, 1),
            "raw_int8_mfu": round(
                2 * rref_mac_per_s * nl * nl / (peak_tops * 1e12),
                5),
            "fraction_of_matmul_rate": round(
                rref_mac_per_s / (nmm**3 / wall_mm), 5),
        },
    }
    del X4

    # tier-B/C at-scale sparse rounds: the d7-scale
    # boundary rank with reduce_each=1 native kernels, and a >= 1M-nnz
    # tier-B kernel basis
    tier_structured = {}
    for tier, p in (("tier_b", LARGE_PRIME_B), ("tier_c", LARGE_PRIME_C)):
        Bt = simplex_boundary(BOUNDARY_N, BOUNDARY_K, p=p)
        wall_t, runs_t, r_t = timed_reps(lambda: st.rank(Bt), 2)
        assert r_t == comb(BOUNDARY_N - 1, BOUNDARY_K), (tier, r_t)
        tier_structured[tier] = {
            "case": f"rank d{BOUNDARY_K} boundary ({Bt.nnz} nnz) mod {p}",
            "wall_s": wall_t, "runs_s": runs_t,
            "nnz_per_s": round(Bt.nnz / wall_t, 1)}
        if tier == "tier_b":
            wall_kb, runs_kb, Kb = timed_reps(lambda: st.kernel(Bt), 2)
            assert Kb.shape[0] == Bt.shape[1] - r_t
            tier_structured["tier_b_kernel"] = {
                "case": f"kernel basis d{BOUNDARY_K} boundary mod {p}",
                "nnz": Bt.nnz, "kernel_rows": Kb.shape[0],
                "wall_s": wall_kb, "runs_s": runs_kb}
            del Kb
        del Bt

    # irregular-workload perf point: random subcomplex
    # boundary — non-uniform row/column weights (GL7d/relat stand-in)
    from spasm_tpu.fixtures import subcomplex_boundary

    IR = subcomplex_boundary(22, 7, keep=0.8, seed=11)
    wall_ir, runs_ir, r_ir = timed_reps(lambda: st.rank(IR), 2)
    r_ir2 = st.rank(IR)
    assert r_ir2 == r_ir
    irregular_detail = {
        "case": "rank subcomplex boundary n=22 k=7 keep=0.8 (irregular "
                "row/col weights; Markowitz fill filter engages)",
        "shape": list(IR.shape), "nnz": IR.nnz, "rank": r_ir,
        "wall_s": wall_ir, "runs_s": runs_ir,
        "nnz_per_s": round(IR.nnz / wall_ir, 1)}
    del IR
    # at-scale irregular: the d9-sized random subcomplex (5.7M nnz)
    IRL = subcomplex_boundary(26, 9, keep=0.8, seed=11)
    wall_irl, runs_irl, r_irl = timed_reps(lambda: st.rank(IRL), 2)
    irregular_detail["large"] = {
        "case": "rank subcomplex boundary n=26 k=9 keep=0.8",
        "shape": list(IRL.shape), "nnz": IRL.nnz, "rank": r_irl,
        "wall_s": wall_irl, "runs_s": runs_irl,
        "nnz_per_s": round(IRL.nnz / wall_irl, 1)}
    del IRL

    # d9 rank certificate: create (includes its own L-recording
    # echelonize) + O(nnz) verify (SURVEY 2.8 failure-detection subsystem)
    from spasm_tpu.certificate import matrix_hash

    h = matrix_hash(C)
    # best-of-2: single-shot host walls vary run to run
    create_runs, verify_runs, proof = [], [], None
    for _ in range(2):
        t0 = time.time()
        proof = st.certificate_rank_create(C, hash_=h)
        create_runs.append(round(time.time() - t0, 3))
        t0 = time.time()
        ok = st.certificate_rank_verify(C, h, proof)
        verify_runs.append(round(time.time() - t0, 3))
        assert ok and proof.r == rc
    cert_detail = {"case": "d9 rank certificate (create incl. L-echelonize)",
                   "create_s": min(create_runs),
                   "create_runs_s": create_runs,
                   "verify_s": min(verify_runs),
                   "verify_runs_s": verify_runs,
                   "rank": proof.r}

    value_c = C.nnz / wall_c
    print(json.dumps({
        "metric": f"rank GL7d-class simplex boundary d{LARGE_K} on "
                  f"{LARGE_N} vertices ({C.nnz} nnz) mod 42013 throughput",
        "value": round(value_c, 1),
        "unit": "nnz/s",
        "vs_baseline": round(value_c / TARGET_NNZ_PER_S, 4),
        "device": device,
        "detail": {
            "rank": rc, "nnz": C.nnz, "wall_s": wall_c, "runs_s": runs_c,
            "median_s": round(statistics.median(runs_c), 3),
            "phases": phases,
            "flagship": {
                "case": f"rank {N}x{N} d={DENSITY} mod 42013 "
                        "(metric-capped, see module docstring)",
                "rank": r, "nnz": A.nnz, "wall_s": wall, "runs_s": runs,
                "nnz_per_s": round(value, 1),
            },
            "structured": {
                "case": f"simplex boundary d{BOUNDARY_K} on "
                        f"{BOUNDARY_N} vertices",
                "shape": list(B.shape), "nnz": B.nnz, "rank": rb,
                "wall_s": wall_b, "runs_s": runs_b,
                "nnz_per_s": round(B.nnz / wall_b, 1),
            },
            "structured_large": large_detail,
            "structured_xl": xl_detail,
            "kernel_basis": kernel_detail,
            "large_prime": large_prime_detail,
            "dense_rref": dense_detail,
            "certificate": cert_detail,
            "device_flagship": device_flagship_detail,
            "mfu": mfu_detail,
            "structured_large_prime": tier_structured,
            "irregular": irregular_detail,
        },
    }))


if __name__ == "__main__":
    main()
