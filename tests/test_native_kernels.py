"""Native (C/OpenMP) kernel equivalence vs the NumPy/scipy fallbacks.

The scatter reductions, the one-pass levels kernel, and the ranged
mutual-reduce sweep (csrc/scatter_mod.c, csrc/schur_mod.c) must agree
bit-for-bit with the pure-Python paths they accelerate."""

import os

import numpy as np
import pytest
import scipy.sparse as sp

from spasm_tpu import elimination as E
from spasm_tpu import native as N
from spasm_tpu.csr import SparseGFp
from spasm_tpu.field import field


@pytest.fixture
def no_native():
    os.environ["SPASM_TPU_NO_NATIVE"] = "1"
    N._libs.clear()
    yield
    del os.environ["SPASM_TPU_NO_NATIVE"]
    N._libs.clear()


def test_scatter_matches_ufunc_at():
    rng = np.random.default_rng(0)
    for n, m in [(50, 7), (1 << 17, 1 << 10)]:
        idx = rng.integers(0, m, n)
        vi = rng.integers(-(1 << 40), 1 << 40, n)
        vf = rng.standard_normal(n)
        for fn, ufunc, tgt in [
                (N.scatter_min, np.minimum, rng.integers(-5, 5, m)),
                (N.scatter_max, np.maximum, rng.integers(-5, 5, m)),
                (N.scatter_add, np.add, rng.integers(-5, 5, m)),
                (N.scatter_min, np.minimum, rng.standard_normal(m)),
                (N.scatter_max, np.maximum, rng.standard_normal(m))]:
            val = vi if tgt.dtype == np.int64 else vf
            a, b = tgt.copy(), tgt.copy()
            fn(a, idx, val)
            ufunc.at(b, idx, val)
            assert np.array_equal(a, b)


def test_levels_one_pass_matches_fixpoint():
    rng = np.random.default_rng(1)
    for _ in range(20):
        r = int(rng.integers(2, 200))
        ne = int(rng.integers(1, 4 * r))
        src = rng.integers(0, r - 1, ne)
        dst = (src + 1 + rng.integers(0, 5, ne)).clip(max=r - 1)
        keep = src < dst
        src, dst = np.sort(src[keep]), dst[keep][np.argsort(src[keep],
                                                            kind="stable")]
        got = N.levels_from_sorted_edges(src, dst, r)
        if got is None:
            pytest.skip("no C compiler")
        exp = np.zeros(r, np.int64)
        for _ in range(r + 1):
            new = exp.copy()
            np.maximum.at(new, dst, exp[src] + 1)
            if np.array_equal(new, exp):
                break
            exp = new
        assert np.array_equal(got, exp)


def _random_pivot_block(rng, f):
    r = int(rng.integers(5, 60))
    m = r + int(rng.integers(0, 40))
    perm = np.sort(rng.permutation(m)[:r])
    rows, cols, vals = [], [], []
    for k in range(r):
        rows.append(k), cols.append(perm[k]), vals.append(1)
        later = np.arange(perm[k] + 1, m)
        extra = rng.choice(later, size=min(int(rng.integers(0, 5)),
                                           later.size), replace=False)
        for c in extra:
            rows.append(k), cols.append(int(c))
            vals.append(int(rng.integers(1, f.p)))
    U = sp.csr_matrix((f.normalize(np.array(vals)), (rows, cols)),
                      shape=(r, m)).astype(np.int64)
    return U, perm


def test_mutual_reduce_native_matches_scipy(no_native):
    rng = np.random.default_rng(2)
    f = field(42013)
    cases = []
    for _ in range(10):
        U, pc = _random_pivot_block(rng, f)
        levels = E.compute_levels(SparseGFp.from_scipy(U, f.p), pc)
        ref, ok = E.mutual_reduce(f, U, pc, levels, fill_cap=None)
        assert ok
        cases.append((U, pc, levels, sp.csr_matrix(ref)))
    del os.environ["SPASM_TPU_NO_NATIVE"]
    N._libs.clear()
    if N._scatter_lib() is None:
        pytest.skip("no C compiler")
    for U, pc, levels, ref in cases:
        got, ok = E.mutual_reduce(f, U, pc, levels, fill_cap=None)
        assert ok
        assert (sp.csr_matrix(got) != ref).nnz == 0
    os.environ["SPASM_TPU_NO_NATIVE"] = "1"  # fixture cleanup symmetry


def test_pivot_scan_path_matches_numpy_path(monkeypatch):
    """The fused native scan (csrc/pivot_scan.c) must select the SAME
    pivots (rows, cols, order, per-strategy counts) as the NumPy
    formulation on every structure class: random sparse, boundary-like,
    band, tall, wide, and matrices where FL-cols / greedy actually fire."""
    from spasm_tpu import pivots as P
    from spasm_tpu.fixtures import simplex_boundary

    if N._pivot_scan_lib() is None:
        pytest.skip("no compiler for native pivot scan")
    rng = np.random.default_rng(7)
    cases = []
    for n, m, d in [(300, 200, 0.02), (200, 300, 0.05), (500, 500, 0.004),
                    (64, 64, 0.3), (1000, 80, 0.05), (80, 1000, 0.05)]:
        f = field(42013)
        cases.append(SparseGFp.rand(f, n, m, d, rng))
    cases.append(simplex_boundary(9, 4))
    # band matrix: heavy support overlap (greedy-active structure)
    i = np.repeat(np.arange(120), 5)
    j = (i + np.tile(np.arange(5), 120)) % 90
    cases.append(SparseGFp.from_coo(field(97), 120, 90, i, j,
                                    rng.integers(1, 97, i.size)))
    for A in cases:
        monkeypatch.setattr(P, "_NATIVE_SCAN_MIN_NNZ", 0)
        r1, c1, k1 = P.find_structural_pivots(A)
        monkeypatch.setattr(P, "_NATIVE_SCAN_MIN_NNZ", 1 << 62)
        r2, c2, k2 = P.find_structural_pivots(A)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(c1, c2)
        assert k1 == k2
        # also the no-greedy variant
        monkeypatch.setattr(P, "_NATIVE_SCAN_MIN_NNZ", 0)
        r1, c1, k1 = P.find_structural_pivots(A, enable_greedy=False)
        monkeypatch.setattr(P, "_NATIVE_SCAN_MIN_NNZ", 1 << 62)
        r2, c2, k2 = P.find_structural_pivots(A, enable_greedy=False)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(c1, c2)
        assert k1 == k2


def _gplu_both_paths(monkeypatch, f, S, record_l):
    """Run _gplu_sequential with and without the native kernel."""
    import importlib

    ech = importlib.import_module("spasm_tpu.echelonize")
    row_origin = np.arange(S.shape[0], dtype=np.int64)
    opts = ech.EchelonizeOptions(L=record_l)
    L1, L2 = [], []
    out_native = ech._gplu_sequential(f, S.copy(), row_origin, 7, opts, L1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(N, "gplu_native", lambda *a, **k: None)
        out_py = ech._gplu_sequential(f, S.copy(), row_origin, 7, opts, L2)
    return out_native, L1, out_py, L2


def test_gplu_native_matches_python(monkeypatch):
    """csrc/gplu_mod.c must reproduce the Python per-row left-looking
    elimination bit-for-bit: U values, pivot columns/rows, L triples."""
    import scipy.sparse as sp

    if N._load("gplu_mod", N._configure_gplu) is None:
        pytest.skip("no compiler for native gplu")
    rng = np.random.default_rng(11)
    cases = []
    for p in (42013, 3, 2147483629):
        f = field(p)
        D = (rng.integers(0, p, (60, 45)).astype(np.int64)
             * (rng.random((60, 45)) < 0.4))
        cases.append((f, sp.csr_matrix(f.normalize(D))))
        E_ = (rng.integers(0, p, (40, 60)).astype(np.int64)
              * (rng.random((40, 60)) < 0.9))  # dense-ish
        cases.append((f, sp.csr_matrix(f.normalize(E_))))
    f = field(42013)
    cases.append((f, sp.csr_matrix((30, 20), dtype=np.int64)))  # zero tail
    for record_l in (False, True):
        for f, S in cases:
            outn, L1, outp, L2 = _gplu_both_paths(None, f, S, record_l)
            assert (outn is None) == (outp is None)
            if outn is None:
                continue
            Un, pcn, prn = outn
            Up, pcp, prp = outp
            np.testing.assert_array_equal(pcn, pcp)
            np.testing.assert_array_equal(prn, prp)
            assert (sp.csr_matrix(Un) != sp.csr_matrix(Up)).nnz == 0
            np.testing.assert_array_equal(Un.data, Up.data)
            if record_l:
                def asm(parts, n, r):
                    li = np.concatenate([np.asarray(t[0]) for t in parts])
                    lk = np.concatenate([np.asarray(t[1]) for t in parts])
                    lv = np.concatenate([np.asarray(t[2]) for t in parts])
                    return sp.csr_matrix((lv, (li, lk)),
                                         shape=(n, r + 16)).toarray()
                r = pcn.size
                np.testing.assert_array_equal(
                    asm(L1, S.shape[0], r + 7), asm(L2, S.shape[0], r + 7))


def test_gplu_sequential_scales_dense_cored():
    """A >=10k-row dense-cored residue (every row pair
    interacts through a shared 256-dim core, so every batched strategy
    degrades to ~1 pivot/round) must finish in seconds through the C
    per-row GPLU, with the exact rank."""
    import time

    from spasm_tpu import echelonize

    if N._load("gplu_mod", N._configure_gplu) is None:
        pytest.skip("no compiler for native gplu")
    f = field(42013)
    rng = np.random.default_rng(5)
    G = rng.integers(0, f.p, (256, 300)).astype(np.int64)   # dense core
    R = rng.integers(1, f.p, (10_000, 256)).astype(np.int64)
    A = SparseGFp.from_dense(f.normalize(R @ G), f.p)
    t0 = time.time()
    fact = echelonize(A, enable_dense=False)
    wall = time.time() - t0
    assert fact.r == 256  # rank(R @ G) = 256 (random full-rank factors)
    # exactness: every row of A eliminates to zero against U
    from spasm_tpu.elimination import eliminate_csr

    res = eliminate_csr(f, fact.U, fact.piv_cols, A)
    assert res.nnz == 0
    assert wall < 60, f"dense-cored GPLU took {wall:.1f}s"


def test_mutual_reduce_one_call_matches_ranged_sweep(monkeypatch):
    """The one-call kernel (csrc/mutual_mod.c: every row finalized once
    against already-final higher-level rows, permutation applied in the
    kernel) must be bit-identical to the per-level ranged sweep it
    replaced, across small and >2^31 primes (reduce_each both ways)."""
    if N._load("mutual_mod", N._configure_mutual,
               extra_flags=("-fopenmp",)) is None:
        pytest.skip("no C compiler")
    rng = np.random.default_rng(5)
    for p in (42013, 3, 2147483629, 4294967291):
        f = field(p)
        for _ in range(4):
            U, pc = _random_pivot_block(rng, f)
            levels = E.compute_levels(SparseGFp.from_scipy(U, f.p), pc)
            got, ok1 = E.mutual_reduce(f, U, pc, levels, fill_cap=None)
            monkeypatch.setattr(N, "mutual_reduce_native",
                                lambda *a, **k: None)
            ref, ok2 = E.mutual_reduce(f, U, pc, levels, fill_cap=None)
            monkeypatch.undo()
            assert ok1 == ok2
            got, ref = sp.csr_matrix(got), sp.csr_matrix(ref)
            assert np.array_equal(got.indptr, ref.indptr)
            assert np.array_equal(got.indices, ref.indices)
            assert np.array_equal(np.asarray(got.data),
                                  np.asarray(ref.data))


def test_cascade_estimator_matches_wave_path(monkeypatch):
    """csrc/cascade_mod.c (per-row heap cascade) must count exactly the
    same surviving nnz as the closure+wave Monte-Carlo path — exact
    elimination against a triangular basis is unique."""
    import importlib

    ECH = importlib.import_module("spasm_tpu.echelonize")
    from spasm_tpu.pivots import find_structural_pivots

    if N._load("cascade_mod", N._configure_cascade) is None:
        pytest.skip("no C compiler")
    rng = np.random.default_rng(11)
    for p in (42013, 2147483629):
        f = field(p)
        A = SparseGFp.rand(f, 250, 220, 0.03, rng)
        prows, pcols, _ = find_structural_pivots(A)
        S = A.to_scipy().astype(np.int64)
        Up = sp.csr_matrix(S[prows])
        npiv = prows.size
        vals = np.asarray(
            Up[np.arange(npiv), pcols]).ravel().astype(np.int64)
        row_of = np.repeat(np.arange(npiv), np.diff(Up.indptr))
        Up.data = f.normalize(Up.data * f.inv(vals)[row_of])
        levels = E.compute_levels(Up, pcols)
        rest = np.setdiff1d(np.arange(250), prows)
        S_rest = sp.csr_matrix(S[rest])
        e1 = ECH.schur_estimate_density(f, Up, pcols, levels, S_rest)
        monkeypatch.setattr(N, "cascade_nnz_native", lambda *a, **k: None)
        e2 = ECH.schur_estimate_density(f, Up, pcols, levels, S_rest)
        monkeypatch.undo()
        assert e1 == e2


def test_gather_and_scale_rows_native():
    """csrc/rowops_mod.c: parallel row gather == scipy fancy-index; row
    scale == the repeat/gather product (both +-1 raw and normalized)."""
    if N._load("rowops_mod", N._configure_rowops,
               extra_flags=("-fopenmp",)) is None:
        pytest.skip("no C compiler")
    rng = np.random.default_rng(3)
    f = field(42013)
    A = SparseGFp.rand(f, 400, 300, 0.02, rng).to_scipy().astype(np.int64)
    A.sort_indices()
    rows = rng.permutation(400)[:173]
    got = N.gather_rows_native(A, rows)
    ref = sp.csr_matrix(A[rows])
    assert got is not None
    assert np.array_equal(got.indptr, ref.indptr)
    assert np.array_equal(got.indices, ref.indices)
    assert np.array_equal(np.asarray(got.data), np.asarray(ref.data))
    # scale: normalized path
    B = sp.csr_matrix(A[rows])
    scales = f.normalize(rng.integers(1, f.p, size=B.shape[0]))
    row_of = np.repeat(np.arange(B.shape[0]), np.diff(B.indptr))
    ref_data = f.normalize(np.asarray(B.data) * scales[row_of])
    C = B.copy()
    assert N.scale_rows_native(f, C, scales, True) is True
    assert np.array_equal(np.asarray(C.data), ref_data)
    # +-1 raw path
    signs = rng.choice(np.array([-1, 1], np.int64), size=B.shape[0])
    ref_data = np.asarray(B.data) * signs[row_of]
    D = B.copy()
    assert N.scale_rows_native(f, D, signs, False) is True
    assert np.array_equal(np.asarray(D.data), ref_data)


def test_cascade_eliminate_matches_wave(monkeypatch):
    """csrc/cascade_mod.c eliminate-with-coefficients (the few-row route
    inside wave_eliminate) must agree with the level-wave path mod p on
    both the residual and the coefficients."""
    from spasm_tpu.pivots import find_structural_pivots

    if N._load("cascade_mod", N._configure_cascade) is None:
        pytest.skip("no C compiler")
    rng = np.random.default_rng(9)
    for p in (42013, 3, 2147483629, 4294967291):
        f = field(p)
        A = SparseGFp.rand(f, 260, 240, 0.04, rng)
        prows, pcols, _ = find_structural_pivots(A)
        npiv = prows.size
        S = A.to_scipy().astype(np.int64)
        Up = sp.csr_matrix(S[prows])
        vals = np.asarray(
            Up[np.arange(npiv), pcols]).ravel().astype(np.int64)
        row_of = np.repeat(np.arange(npiv), np.diff(Up.indptr))
        Up.data = f.normalize(Up.data * f.inv(vals)[row_of])
        levels = E.compute_levels(Up, pcols)
        rest = np.setdiff1d(np.arange(260), prows)[:5]
        B = sp.csr_matrix(S[rest])
        D1, C1 = E.wave_eliminate(f, Up, pcols, levels, B,
                                  record_coeffs=True,
                                  assume_canonical=True)
        monkeypatch.setattr(N, "cascade_eliminate_native",
                            lambda *a, **k: None)
        D2, C2 = E.wave_eliminate(f, Up, pcols, levels, B,
                                  record_coeffs=True,
                                  assume_canonical=True)
        monkeypatch.undo()
        for X, Y in ((D1, D2), (C1, C2)):
            d = (X - Y)
            d.data %= p
            d.eliminate_zeros()
            assert d.nnz == 0


def test_mutual_reduce_fill_cap_falls_back():
    """A tiny fill_cap must make mutual_reduce return (U, False) on both
    the native one-call path and the sweep, and the round loop's wave
    fallback must still produce the right rank."""
    rng = np.random.default_rng(21)
    f = field(42013)
    # chain block: row k hits col(k+1..k+6) -> heavy fill under RREF
    r, m = 80, 160
    pc = np.arange(r) * 2
    rows, cols, vals = [], [], []
    for k in range(r):
        rows.append(k); cols.append(pc[k]); vals.append(1)
        for k2 in range(k + 1, min(k + 7, r)):
            rows.append(k); cols.append(pc[k2])
            vals.append(int(rng.integers(1, f.p)))
        rows.append(k); cols.append(2 * k + 1)
        vals.append(int(rng.integers(1, f.p)))
    U = sp.csr_matrix((f.normalize(np.array(vals, np.int64)),
                       (rows, cols)), shape=(r, m))
    U.sort_indices()
    levels = E.compute_levels(U, pc)
    W, ok = E.mutual_reduce(f, U, pc, levels, fill_cap=None)
    assert ok and W.nnz > 4 * U.nnz  # genuinely fill-heavy
    W2, ok2 = E.mutual_reduce(f, U, pc, levels, fill_cap=1.5)
    assert not ok2 and W2 is U  # capped -> original block returned


def test_kernels_correct_under_restricted_omp_runtime():
    """The chunk-loop work distribution must be correct when the OpenMP
    runtime delivers fewer threads than requested (OMP_DYNAMIC=true,
    OMP_THREAD_LIMIT=2) — the old tid-indexed ranges left rows
    unprocessed in that configuration.  Runs in a subprocess because the
    OpenMP runtime reads its env at first use."""
    import subprocess
    import sys

    code = r"""
import numpy as np, scipy.sparse as sp, importlib
elim = importlib.import_module("spasm_tpu.elimination")
from spasm_tpu.field import Field
from spasm_tpu.csr import SparseGFp
from spasm_tpu.pivots import find_structural_pivots
rng = np.random.default_rng(3)
f = Field(42013)
A = SparseGFp.rand(f, 400, 360, 0.03, rng)
prows, pcols, _ = find_structural_pivots(A)
S = A.to_scipy().astype(np.int64)
Up = sp.csr_matrix(S[prows])
npiv = prows.size
vals = np.asarray(Up[np.arange(npiv), pcols]).ravel().astype(np.int64)
row_of = np.repeat(np.arange(npiv), np.diff(Up.indptr))
Up.data = f.normalize(Up.data * f.inv(vals)[row_of])
levels = elim.compute_levels(Up, pcols)
Ustar, ok = elim.mutual_reduce(f, Up, pcols, levels)
assert ok
rest = np.setdiff1d(np.arange(400), prows)
B = sp.csr_matrix(S[rest])
D, _ = elim.eliminate_against_reduced(f, Ustar, pcols, B,
                                      assume_canonical=True)
# oracle: scipy product (small p: no overflow at these sizes)
cols = sp.csc_matrix(B)[:, pcols]
ref = B - cols @ sp.csr_matrix(Ustar)
ref.data %= f.p
d = D - ref
d.data %= f.p
d.eliminate_zeros()
assert d.nnz == 0, d.nnz
print("RESTRICTED-OMP-OK")
"""
    env = dict(os.environ, OMP_DYNAMIC="true", OMP_THREAD_LIMIT="2",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "RESTRICTED-OMP-OK" in out.stdout, (out.stdout, out.stderr)


def test_native_surface_edges():
    """Edge shapes of the new native helpers: empty gathers, empty
    normalize, scale no-op, release hook, SMS writer on zero entries."""
    f = field(42013)
    A = sp.csr_matrix((np.array([3, -5], np.int64),
                       np.array([1, 2], np.int32),
                       np.array([0, 1, 2], np.int64)), shape=(2, 4))
    # empty row selection
    g = N.gather_rows_native(A, np.zeros(0, np.int64))
    if g is not None:
        assert g.shape == (0, 4) and g.nnz == 0
    # normalize of an empty vector via the Field path
    assert f.normalize(np.zeros(0, np.int64)).size == 0
    # scale identity fast path (all ones) leaves data untouched
    B = A.copy()
    out = N.scale_rows_native(f, B, np.ones(2, np.int64), True)
    if out is not None:
        assert np.array_equal(np.asarray(B.data), np.asarray(A.data))
    # SMS writer with zero triples
    body = N.format_sms_triples_native(np.zeros(0, np.int64),
                                       np.zeros(0, np.int64),
                                       np.zeros(0, np.int64))
    if body is not None:
        assert bytes(body) == b""
    # arena release is callable any time (no-op before first kernel use)
    N.release_native_scratch()


def test_parallel_sms_parser_matches_sequential():
    """The chunked OpenMP tokenizer must parse exactly what the
    sequential one does, including blank lines, negative values,
    a mid-file terminator and junk after it (dropped by both)."""
    lib = N.get_lib()
    if lib is None:
        pytest.skip("no C compiler")
    rng = np.random.default_rng(17)
    nrows = 320_000  # ~5 MB > the 4 MB par-path threshold
    i = rng.integers(1, 5000, nrows)
    j = rng.integers(1, 4000, nrows)
    v = rng.integers(-(10**9), 10**9, nrows)
    v[v == 0] = 1
    lines = [f"5000 4000 M"]
    for k in range(nrows):
        lines.append(f"{i[k]} {j[k]} {v[k]}")
        if k % 50_000 == 0:
            lines.append("")  # blank line
    lines.append("0 0 0")
    lines.append("9 9 9")  # junk after the terminator: dropped
    raw = ("\n".join(lines) + "\n").encode()
    assert len(raw) >= (1 << 22)
    par = N.parse_sms_native(raw)
    # force the sequential tokenizer by shrinking under the threshold:
    # parse a truncated prefix equivalence is awkward — instead call the
    # sequential C entry point directly
    import ctypes
    header = (ctypes.c_int64 * 2)()
    cap = raw.count(b"\n") + 2
    out = np.empty(3 * cap, dtype=np.int64)
    count = lib.spasm_tpu_parse_sms(
        raw, len(raw), header,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    assert count >= 0
    tri = out[:3 * count].reshape(-1, 3)
    assert par is not None
    n, m, pi, pj, pv = par
    assert (n, m) == (int(header[0]), int(header[1])) == (5000, 4000)
    assert pi.size == count == nrows
    assert np.array_equal(pi, tri[:, 0])
    assert np.array_equal(pj, tri[:, 1])
    assert np.array_equal(pv, tri[:, 2])


def test_native_load_all_builds_every_library():
    import glob
    import os

    from spasm_tpu import native

    loaded = native.load_all()
    names = {os.path.basename(p)[:-2]
             for p in glob.glob(os.path.join(native._CSRC, "*.c"))}
    assert set(loaded) == names
    assert all(loaded.values())
