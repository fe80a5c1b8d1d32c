#!/usr/bin/env python
"""Time the dense device kernels on the GPU and attribute the device
finish's time to its parts.

1. modmatmul at 4096^3 for p = 42013 (2 limbs) and p = 2**31 - 19
   (4 limbs): best wall, raw int8 TOP/s (2 n^3 nl^2 / wall), the int8 GEMM
   kernels XLA chose, and an exactness check (a 64-row slab against an
   exact host product).
2. One profiler trace of the device-flagship rank
   (SparseGFp.rand(8192, 8192, 0.02), seed 5, p = 42013): device busy
   time, and per-kernel device time and launch count.  Kernels launched
   once per pivot step of the panel loop (ops/dense._panel_eliminate) run
   at least PANEL_STEP_MIN times; their sum is the panel loop's share.

    python tools/dense_kernels_profile.py [--out chiprun_out/dense_profile]

Needs a GPU.  Writes <out>/report.json and the trace under <out>/trace.
"""

import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_MM = 4096      # modmatmul edge
N_FLAG = 8192    # device-flagship edge
# launch-count floor of a per-pivot-step kernel: the flagship's finish
# runs one 128-step panel loop per non-empty panel (thousands of steps);
# the group-level matmuls and corrections launch a few hundred times
PANEL_STEP_MIN = 2048


def card_identity() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def exact_rows(f, a, b, rows):
    """a[rows] @ b mod p exactly in int64 for p < 2**31: b splits into
    16-bit halves so every partial sum stays below 2**62."""
    a = a[rows].astype(np.int64)
    b = b.astype(np.int64) % f.p
    lo = a @ (b & 0xFFFF)
    hi = a @ (b >> 16)
    return f.normalize((hi % f.p) * 65536 + lo % f.p)


def matmul_phase(report):
    import jax
    import jax.numpy as jnp

    from spasm_tpu.field import field, num_limbs
    from spasm_tpu.ops.matmul import modmatmul

    n = N_MM
    ok = True
    for p in (42013, 2147483629):
        f = field(p)
        rng = np.random.default_rng(6)
        a = f.rand((n, n), rng).astype(np.int32)
        b = f.rand((n, n), rng).astype(np.int32)
        ad, bd = jnp.asarray(a), jnp.asarray(b)
        comp = jax.jit(lambda x, y, f=f: modmatmul(f, x, y)).lower(
            ad, bd).compile()
        c = np.asarray(comp(ad, bd))
        exact = bool(np.array_equal(c[:64], exact_rows(f, a, b,
                                                       slice(0, 64))))
        ok &= exact
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            jax.block_until_ready(comp(ad, bd))
            walls.append(time.perf_counter() - t0)
        nl = num_limbs(p)
        kernels = sorted({
            line.split('custom_call_target="')[1].split('"')[0]
            if "custom_call_target=" in line
            else line.split('"kind":"')[1].split('"')[0]
            for line in comp.as_text().splitlines()
            if "custom_call_target=" in line
            or ("gemm_fusion" in line and '"kind":"' in line)})
        rec = {"p": p, "limbs": nl, "exact_slab": exact,
               "best_s": min(walls), "median_s": float(np.median(walls)),
               "raw_int8_tops": 2 * n**3 * nl * nl / min(walls) / 1e12,
               "gemm_kernels": kernels,
               "memory": str(comp.memory_analysis())}
        print(json.dumps(rec), flush=True)
        report["modmatmul"].append(rec)
    return ok


def trace_phase(report, out_dir):
    import jax
    from jax.profiler import ProfileData

    import spasm_tpu as st

    f = st.field(42013)
    A = st.SparseGFp.rand(f, N_FLAG, N_FLAG, 0.02, np.random.default_rng(5))
    st.rank(A)  # compile
    t0 = time.perf_counter()
    st.rank(A)
    untraced = time.perf_counter() - t0
    tdir = os.path.join(out_dir, "trace")
    jax.profiler.start_trace(tdir)
    t0 = time.perf_counter()
    st.rank(A)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    dur = collections.Counter()
    count = collections.Counter()
    busy = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                dur[ev.name[:80]] += ev.duration_ns
                count[ev.name[:80]] += 1
    busy.sort()
    union, end = 0, -1
    for s, e in busy:
        if e > end:
            union += e - max(s, end)
            end = e
    total = sum(dur.values())
    panel = sum(v for k, v in dur.items() if count[k] >= PANEL_STEP_MIN)
    gemm = sum(v for k, v in dur.items() if "gemm" in k or "dot" in k)
    rec = {"untraced_wall_s": untraced, "traced_wall_s": wall,
           "device_busy_s": union / 1e9, "kernel_sum_s": total / 1e9,
           "panel_step_kernels_s": panel / 1e9,
           "panel_step_share": panel / total if total else None,
           "gemm_kernels_s": gemm / 1e9,
           "top_kernels": {k: {"s": v / 1e9, "count": count[k]}
                           for k, v in dur.most_common(30)}}
    print(json.dumps({k: v for k, v in rec.items() if k != "top_kernels"}),
          flush=True)
    report["flagship_trace"] = rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/dense_profile")
    args = ap.parse_args()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("no GPU found", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    report = {"card": card_identity(), "device_kind": dev.device_kind,
              "modmatmul": []}
    print(report["card"], dev.device_kind, flush=True)
    ok = matmul_phase(report)
    trace_phase(report, args.out)
    with open(os.path.join(args.out, "report.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print("ALL OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
