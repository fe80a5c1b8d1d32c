#!/usr/bin/env python
"""Smoke run of spasm_tpu's main path on one GPU, through the public entry
points, at real sizes, with exact oracles (the tolerance is zero: this is
arithmetic mod p).

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the mesh phase only

The parent process never imports JAX.  It runs each phase as a child
process, one after the other, so only one process ever holds the card;
the children share the persistent compilation cache of the package.
Phases (each fails the run if it fails):

  identity    JAX sees a GPU (no CPU fallback)
  native      every C library in csrc/ is built and loaded
  kernels     modmatmul at 4096^3 (p = 42013, 2 limbs; p = 2^31 - 19,
              4 limbs) against an exact host product; dense RREF tiers
              A/B/C against the host Gauss-Jordan
  e2e         d9 boundary rank and kernel basis, device-flagship rank and
              kernel, 4096^2 rank against host GPLU, gesv with 64
              right-hand sides on the d7 boundary
  cli         `python -m spasm_tpu.cli rank` on the d7 boundary as SMS
  chip_tests  the pytest tests marked `chip`
  four        (--four only) full-mesh echelonize of the d7 boundary and
              the sharded dense elimination round against one device

The last line of stdout is {"ok": true, "device": {...}}; it is printed
only when every phase passed.
"""

import json
import os
import subprocess
import sys
import time
from math import comb

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".build", "smoke")
PHASES = ["identity", "native", "kernels", "e2e", "cli", "chip_tests"]
# real sizes of each case (rehearsals on the CPU shrink them)
SIZES = {"mm": 4096, "rref_a": 2048, "rref_bc": 1024, "d9": (26, 9),
         "flagship": 8192, "gplu": 4096, "d7": (22, 7)}
TIMEOUT_S = {"identity": 120, "native": 180, "kernels": 600, "e2e": 600,
             "cli": 240, "chip_tests": 420, "four": 900}


def card_identity() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def say(*args):
    print(*args, flush=True)


# ------------------------------------------------------------ host oracles


def host_modmatmul(p: int, a, b):
    """a @ b mod p exactly, for p < 2**31 and k < 2**21: both operands
    split into 16-bit limbs, so each float64 product sum stays below
    2**53 and BLAS computes it exactly."""
    import numpy as np

    def split(x):
        x = np.asarray(x, np.int64)
        lo = x & 0xFFFF
        return lo.astype(np.float64), ((x - lo) >> 16).astype(np.float64)

    a0, a1 = split(a)
    b0, b1 = split(b)

    def mm(x, y):
        return (x @ y).astype(np.int64) % p

    c = (mm(a1, b1) * pow(2, 32, p) % p
         + (mm(a1, b0) + mm(a0, b1)) % p * 65536 + mm(a0, b0)) % p
    return np.where(c > p // 2, c - p, c)


def kernel_is_null(A, K, p: int, rng) -> bool:
    """Freivalds: A @ (K^T @ v) == 0 mod p for two random v (O(nnz))."""
    import numpy as np

    As, Ks = A.to_scipy(), K.to_scipy()
    for _ in range(2):
        v = rng.integers(0, 1 << 15, K.shape[0]).astype(np.int64)
        w = (Ks.T @ v) % p
        if np.any((As @ w) % p):
            return False
    return True


# ------------------------------------------------------------ phases


def require_gpus(n: int) -> bool:
    import jax

    devs = jax.devices()
    say("jax.devices():", devs)
    if devs[0].platform != "gpu" or len(devs) < n:
        say(f"needs {n} GPU(s): JAX platform is {devs[0].platform!r}, "
            f"{len(devs)} device(s)")
        return False
    return True


def phase_identity():
    import jax

    if not require_gpus(1):
        return 1
    devs = jax.devices()
    d = devs[0]
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, "device.json"), "w") as fh:
        json.dump({"platform": d.platform, "kind": d.device_kind,
                   "count": len(devs)}, fh)
    return 0


def phase_native():
    from spasm_tpu import native

    if os.environ.get("SPASM_TPU_NO_NATIVE"):
        say("SPASM_TPU_NO_NATIVE is set")
        return 1
    t0 = time.perf_counter()
    loaded = native.load_all()
    say(f"native libraries ({time.perf_counter() - t0:.1f} s):", loaded)
    return 0 if all(loaded.values()) else 1


def _xla_gemm_kernels(hlo_text: str):
    """Names of the matrix-product kernels in compiled HLO: library custom
    calls (cuBLAS/cuBLASLt) and XLA's Triton GEMM fusions, with kind."""
    names = set()
    for line in hlo_text.splitlines():
        if "custom_call_target=" in line:
            names.add(line.split('custom_call_target="')[1].split('"')[0])
        elif '"kind":"__' in line and " = " in line:
            inst = line.split(" = ")[0].split()[-1].lstrip("%")
            kind = line.split('"kind":"')[1].split('"')[0]
            if "gemm" in kind or "gemm" in inst or "dot" in inst:
                names.add(f"{inst} ({kind})")
    return sorted(names)


def phase_kernels():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import spasm_tpu as st
    from spasm_tpu.field import num_limbs
    from spasm_tpu.ops import dense as dense_ops
    from spasm_tpu.ops.matmul import modmatmul

    ok = True
    n = SIZES["mm"]
    for p in (42013, 2147483629):
        f = st.field(p)
        rng = np.random.default_rng(6)
        a = f.rand((n, n), rng).astype(np.int32)
        b = f.rand((n, n), rng).astype(np.int32)
        want = host_modmatmul(p, a, b)
        ad, bd = jnp.asarray(a), jnp.asarray(b)
        comp = jax.jit(lambda x, y, f=f: modmatmul(f, x, y)).lower(
            ad, bd).compile()
        say(f"modmatmul p={p} int8 GEMM kernels (XLA):",
            _xla_gemm_kernels(comp.as_text()))
        say(f"modmatmul p={p} memory_analysis:", comp.memory_analysis())
        got = np.asarray(comp(ad, bd))
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(comp(ad, bd))
            walls.append(time.perf_counter() - t0)
        exact = bool(np.array_equal(got, want))
        ok &= exact
        say(f"modmatmul {n}^3 p={p} limbs={num_limbs(p)} exact={exact} "
            f"best {min(walls) * 1e3:.3f} ms")
    for tier, p, size in (("A", 42013, SIZES["rref_a"]),
                          ("B", 2147483629, SIZES["rref_bc"]),
                          ("C", 4294967291, SIZES["rref_bc"])):
        f = st.field(p)
        X = f.rand((size, size), np.random.default_rng(2))
        X[np.random.default_rng(3).random((size, size)) > 0.5] = 0
        t0 = time.perf_counter()
        got = dense_ops.rref(f, X, host_cutoff=0)
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = dense_ops._host_rref(f, X, False)
        t_host = time.perf_counter() - t0
        exact = (got["rank"] == want["rank"]
                 and np.array_equal(got["piv_cols"], want["piv_cols"])
                 and np.array_equal(got["R"][got["piv_rows"]],
                                    want["R"][want["piv_rows"]]))
        ok &= bool(exact)
        say(f"dense rref tier {tier} p={p} {size}^2 rank={got['rank']} "
            f"exact={exact} device {t_dev:.2f} s (incl. compile), "
            f"host oracle {t_host:.2f} s")
    return 0 if ok else 1


def _timed(label, fn):
    from spasm_tpu.echelonize import last_phase_stats

    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    stats = last_phase_stats()
    say(f"{label}: wall {wall:.3f} s, phases "
        + json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in stats.items()}))
    return out, stats


def phase_e2e():
    import numpy as np
    import scipy.sparse as sp

    import spasm_tpu as st
    from spasm_tpu.fixtures import simplex_boundary
    from spasm_tpu.utils.hostmem import tune_host_malloc

    tune_host_malloc()
    say("card:", card_identity())
    ok = True
    p = 42013
    rng = np.random.default_rng(11)

    # d9 boundary: host rounds + native Schur
    nv, k = SIZES["d9"]
    C = simplex_boundary(nv, k)
    r, _ = _timed(f"d9 rank {C.shape} {C.nnz} nnz", lambda: st.rank(C))
    ok &= r == comb(nv - 1, k)
    say(f"d9 rank = {r} (C({nv - 1},{k}) = {comb(nv - 1, k)})")
    K, _ = _timed("d9 kernel basis", lambda: st.kernel(C))
    good = K.shape[0] == C.shape[1] - r and kernel_is_null(C, K, p, rng)
    ok &= good
    say(f"d9 kernel rows {K.shape[0]} == m - r: {K.shape[0] == C.shape[1] - r}"
        f", A K^T v == 0: {good}")
    del C, K

    # device flagship: the fused device dense finish
    f = st.field(p)
    nf = SIZES["flagship"]
    DF = st.SparseGFp.rand(f, nf, nf, 0.02, np.random.default_rng(5))
    st.rank(DF)  # compile
    r, stats = _timed(f"device flagship rank {nf}^2 {DF.nnz} nnz",
                      lambda: st.rank(DF))
    on_device = stats["device_s"] > 0
    K, _ = _timed("device flagship kernel", lambda: st.kernel(DF))
    good = K.shape[0] == nf - r and kernel_is_null(DF, K, p, rng)
    ok &= good and on_device
    say(f"device flagship rank {r}, device_s > 0: {on_device}, kernel rows "
        f"{K.shape[0]}, A K^T v == 0: {good}")
    del DF, K

    # 4096^2 d=0.05: device finish against host GPLU
    ng = SIZES["gplu"]
    A4 = st.SparseGFp.rand(f, ng, ng, 0.05, np.random.default_rng(5))
    r_dev, stats = _timed(f"{ng}^2 d=0.05 rank ({A4.nnz} nnz)",
                          lambda: st.rank(A4))
    r_host, _ = _timed(f"{ng}^2 host GPLU rank",
                       lambda: st.echelonize(A4, enable_dense=False).r)
    ok &= r_dev == r_host
    say(f"{ng}^2 rank device {r_dev} == host {r_host}: {r_dev == r_host}")
    del A4

    # gesv: 64 right-hand sides against one L-recorded factorization
    B7 = simplex_boundary(*SIZES["d7"])
    os.makedirs(WORK, exist_ok=True)
    st.save_sms(B7, os.path.join(WORK, "d7.sms"))
    fact, _ = _timed("d7 echelonize(L=True)",
                     lambda: st.echelonize(B7, L=True))
    Y = sp.random(64, B7.shape[0], density=4e-5, format="csr",
                  random_state=7, dtype=np.float64)
    Y.data = rng.integers(1, p, Y.nnz).astype(np.float64)
    Y = sp.csr_matrix(Y.astype(np.int64))
    A7 = B7.to_scipy()
    Bm = sp.csr_matrix((Y @ A7).toarray() % p)
    RHS = st.SparseGFp.from_scipy(Bm, p)
    t0 = time.perf_counter()
    X, solved = st.gesv(fact, RHS)
    wall = time.perf_counter() - t0
    back = (X.to_scipy() @ A7).toarray() % p
    good = bool(solved.all()) and np.array_equal(back, Bm.toarray() % p)
    ok &= good
    say(f"d7 gesv 64 rhs: wall {wall:.3f} s, all solvable "
        f"{bool(solved.all())}, x A == b: {good}")
    return 0 if ok else 1


def phase_cli():
    sms = os.path.join(WORK, "d7.sms")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "spasm_tpu.cli", "rank",
                          "--modulus", "42013", sms], cwd=ROOT,
                         capture_output=True, text=True)
    wall = time.perf_counter() - t0
    nv, k = SIZES["d7"]
    want = f"rank = {comb(nv - 1, k)}"
    good = out.returncode == 0 and want in out.stderr.splitlines()
    say(f"cli rank d7: rc {out.returncode}, wall {wall:.2f} s, "
        f"prints '{want}': {good}")
    if not good:
        say(out.stderr[-3000:])
    return 0 if good else 1


def phase_chip_tests():
    env = dict(os.environ, SPASM_TPU_DEVICE_TESTS="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "chip", "-q",
         "-p", "no:cacheprovider", "-rs"], cwd=ROOT, env=env,
        capture_output=True, text=True)
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    say("chip tests:", tail)
    good = out.returncode == 0 and "skipped" not in tail and "passed" in tail
    if not good:
        say(out.stdout[-4000:], out.stderr[-2000:])
    return 0 if good else 1


def phase_four():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import spasm_tpu as st
    from spasm_tpu.fixtures import simplex_boundary
    from spasm_tpu.parallel.sharded import elimination_round, make_mesh

    if not require_gpus(4):
        return 1
    say("cards:", card_identity().replace("\n", " | "))
    ok = True
    mesh = make_mesh(4)
    nv, k = SIZES["d7"]
    A = simplex_boundary(nv, k)
    want = comb(nv - 1, k)
    st.echelonize(A, mesh=mesh)  # compile
    r_mesh, _ = _timed("d7 mesh echelonize (4 GPUs)",
                       lambda: st.echelonize(A, mesh=mesh).r)
    r_one, _ = _timed("d7 single-card host loop",
                      lambda: st.echelonize(A).r)
    ok &= r_mesh == want == r_one
    say(f"d7 rank mesh {r_mesh}, single {r_one}, C({nv - 1},{k}) = {want}")

    f = st.field(42013)
    # sparse rows spread their leftmost nonzeros, so the round elects
    # many pivots
    rng = np.random.default_rng(9)
    X = f.rand((4 * 2048, 2048), rng).astype(np.int32)
    X[rng.random(X.shape) > 0.01] = 0
    step = jax.jit(elimination_round, static_argnums=(0, 1, 3))
    outs = {}
    for nd in (1, 4):
        m = make_mesh(nd)
        Xs = jax.device_put(jnp.asarray(X), NamedSharding(m, P("rows", None)))
        res = jax.block_until_ready(step(f, m, Xs, 128))
        t0 = time.perf_counter()
        res = jax.block_until_ready(step(f, m, Xs, 128))
        wall = time.perf_counter() - t0
        placed = sorted({s.device.id for s in res[0].addressable_shards})
        say(f"elimination_round (8192, 2048) on {nd} device(s): "
            f"{wall * 1e3:.2f} ms, X' shards on devices {placed}, "
            f"npiv {int(res[4])}")
        ok &= placed == list(range(nd))
        outs[nd] = [np.asarray(x) for x in res]
    same = all(np.array_equal(a, b) for a, b in zip(outs[1], outs[4]))
    ok &= same
    say(f"sharded round identical to one device: {same}")
    return 0 if ok else 1


# ------------------------------------------------------------ driver


def run_child(name: str) -> int:
    cmd = [sys.executable, os.path.abspath(__file__), "--phase", name]
    say(f"== phase {name}")
    t0 = time.perf_counter()
    try:
        rc = subprocess.run(cmd, cwd=ROOT, timeout=TIMEOUT_S[name]).returncode
    except subprocess.TimeoutExpired:
        rc = 124
    say(f"== phase {name}: rc {rc}, {time.perf_counter() - t0:.1f} s")
    return rc


def main(argv):
    if "--phase" in argv:
        name = argv[argv.index("--phase") + 1]
        sys.path.insert(0, ROOT)
        return globals()[f"phase_{name}"]()
    if not os.path.isfile(os.path.join(ROOT, "spasm_tpu", "__init__.py")):
        print("chip_smoke.py must run from a spasm_tpu checkout",
              file=sys.stderr)
        return 1
    try:
        card = card_identity()
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"nvidia-smi failed: {exc}", file=sys.stderr)
        return 1
    say("card (name, power limit):", card.replace("\n", " | "))
    phases = ["identity", "four"] if "--four" in argv else PHASES
    for name in phases:
        if run_child(name) != 0:
            print(f"phase {name} failed", file=sys.stderr)
            return 1
    with open(os.path.join(WORK, "device.json")) as fh:
        device = json.load(fh)
    say("card (name, power limit):", card.replace("\n", " | "))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
