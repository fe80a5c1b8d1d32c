"""End-to-end echelonize / rank / kernel / solve — golden values from the
reference (README.md:12-47, test/runtests.jl) plus randomized oracles."""

import numpy as np
import pytest

import spasm_tpu as st
from spasm_tpu import SparseGFp, echelonize, field, gesv, kernel, rank, solve
from spasm_tpu.solve import (kernel_from_rref, rref_of_U,
                             sparse_triangular_solve)

F = field(42013)


def dense_rank_oracle(p, X):
    """Rank via fractions-free elimination over GF(p) with python ints."""
    X = [[int(v) % p for v in row] for row in np.asarray(X)]
    n = len(X)
    m = len(X[0]) if n else 0
    rank = 0
    for j in range(m):
        piv = None
        for i in range(rank, n):
            if X[i][j] % p:
                piv = i
                break
        if piv is None:
            continue
        X[rank], X[piv] = X[piv], X[rank]
        inv = pow(X[rank][j], p - 2, p)
        X[rank] = [(v * inv) % p for v in X[rank]]
        for i in range(n):
            if i != rank and X[i][j]:
                c = X[i][j]
                X[i] = [(a - c * b) % p for a, b in zip(X[i], X[rank])]
        rank += 1
    return rank


def check_fact(A, fact):
    """Structural invariants of an LU result."""
    f = A.field
    r = fact.r
    assert fact.U.shape == (r, A.m)
    # unit pivots at qinv-located columns
    for k in range(r):
        assert fact.U[k, int(fact.piv_cols[k])] == 1
    assert (fact.qinv[fact.piv_cols] == np.arange(r)).all()
    # U rows span subset of row space: rank(U) == r
    assert dense_rank_oracle(f.p, fact.U.to_dense()) == r
    # row space of U == row space of A: every row of A reduces to zero
    from spasm_tpu.elimination import wave_eliminate
    res, _ = wave_eliminate(f, fact.U.to_scipy(), fact.piv_cols,
                            fact.levels, A.to_scipy())
    assert res.nnz == 0


# ---------------- golden reference cases ----------------


def test_readme_2x2():
    # README.md:12-47: m = [[1 2];[3 6]] mod 42013 -> rank 1, kernel
    # [3, 42012].  The Julia wrapper transposes on construction
    # (README.md:7), so the reference's kernel(CSR(m)) is computed on m^T.
    A = SparseGFp.from_dense([[1, 3], [2, 6]], 42013)  # m^T
    fact = echelonize(A)
    assert fact.r == 1
    check_fact(A, fact)
    k = kernel(A)
    np.testing.assert_array_equal(k.to_dense(), [[3, -1]])
    # and the untransposed matrix for completeness
    k2 = kernel(A.T)
    np.testing.assert_array_equal(k2.to_dense(), [[2, -1]])


def test_runtests_3x4():
    # test/runtests.jl: m = sparse([1,1,3,3],[1,2,3,4],[1,2,3,4]).
    # The Julia wrapper transposes on construction, so the reference's
    # kernel(CSR(m)) is the kernel of m^T and vice versa.
    m = SparseGFp.from_coo(F, 3, 4, [0, 0, 2, 2], [0, 1, 2, 3],
                           [1, 2, 3, 4])
    # kernel of m^T  (1 x 3, value -1 at column 2) — runtests.jl:21
    k1 = kernel(m.T)
    np.testing.assert_array_equal(k1.to_dense(), [[0, -1, 0]])
    # kernel of m  (2 x 4) — runtests.jl:23 golden values (28010 is the
    # unsigned lift of balanced -14003; ZZp normalizes identically)
    k2 = kernel(m)
    np.testing.assert_array_equal(
        k2.to_dense(), [[2, -1, 0, 0], [0, 0, -14003, -1]])
    assert F.to_unsigned(np.array([-14003]))[0] == 28010


def test_rank_one_stop():
    A = SparseGFp.from_dense([[1, 2], [3, 6]], 42013)
    assert rank(A) == 1
    assert rank(A.T) == 1


# ---------------- randomized oracles ----------------


@pytest.mark.parametrize("shape,density", [
    ((30, 40), 0.1), ((40, 30), 0.1), ((50, 50), 0.05), ((20, 20), 0.5),
])
def test_random_rank(shape, density, rng):
    A = SparseGFp.rand(F, *shape, density, rng)
    fact = echelonize(A)
    assert fact.r == dense_rank_oracle(F.p, A.to_dense())
    check_fact(A, fact)


def test_low_rank(rng):
    f = F
    B = SparseGFp.rand(f, 40, 5, 0.3, rng)
    C = SparseGFp.rand(f, 5, 35, 0.3, rng)
    A = B @ C
    fact = echelonize(A)
    assert fact.r == dense_rank_oracle(f.p, A.to_dense())
    check_fact(A, fact)


def test_kernel_property(rng):
    A = SparseGFp.rand(F, 25, 35, 0.12, rng)
    fact = echelonize(A)
    k = kernel(fact)
    assert k.shape == (35 - fact.r, 35)
    # A @ k.T == 0
    prod = A @ k.T
    assert prod.nnz == 0
    # kernel rows independent
    assert dense_rank_oracle(F.p, k.to_dense()) == k.shape[0]


def test_kernel_of_zero_matrix():
    A = SparseGFp.zeros(F, 4, 6)
    k = kernel(A)
    assert k.shape == (6, 6)
    np.testing.assert_array_equal(k.to_dense(), -np.eye(6, dtype=int))


def test_rref_unique(rng):
    A = SparseGFp.rand(F, 20, 25, 0.15, rng)
    # RREF must be identical whatever the options / pivot path
    f1 = echelonize(A)
    f2 = echelonize(A, enable_greedy_pivot_search=False)
    f3 = echelonize(A, max_round=0)  # pure dense finish
    r1, r2, r3 = rref_of_U(f1), rref_of_U(f2), rref_of_U(f3)
    assert r1 == r2 == r3


def test_L_factor(rng):
    A = SparseGFp.rand(F, 25, 30, 0.15, rng)
    fact = echelonize(A, L=True)
    assert fact.L is not None
    # A == L @ U exactly
    assert fact.L @ fact.U == A
    # rows of L at pivots: triangular with nonzero diagonal in the
    # structural region; the dense-finish corner block is merely invertible
    Lp = fact.L.select_rows(fact.p).to_dense()
    ds = fact.dense_piv_start if fact.dense_piv_start is not None else fact.r
    assert (np.diag(Lp)[:ds] != 0).all()
    assert not np.triu(Lp[:ds, :ds], 1).any()
    assert not Lp[:ds, ds:].any()  # upper-right block is zero
    assert dense_rank_oracle(F.p, Lp[ds:, ds:]) == fact.r - ds


def test_solve(rng):
    A = SparseGFp.rand(F, 20, 26, 0.2, rng)
    fact = echelonize(A, L=True)
    # consistent RHS: b = x0 @ A
    x0 = F.rand(20, rng)
    b = F.normalize(x0 @ A.to_dense().astype(np.int64))
    x = solve(fact, b)
    assert x is not None
    np.testing.assert_array_equal(
        F.normalize(x @ A.to_dense().astype(np.int64)), b)
    # inconsistent RHS (generic random is outside a rank<=20 row space)
    if fact.r < 26:
        b_bad = F.rand(26, rng)
        while not (F.normalize(b_bad @ kernel(fact).T.to_dense()
                               .astype(np.int64)) != 0).any():
            b_bad = F.rand(26, rng)  # pragma: no cover
        assert solve(fact, b_bad) is None


def test_gesv(rng):
    A = SparseGFp.rand(F, 15, 20, 0.25, rng)
    fact = echelonize(A, L=True)
    X0 = SparseGFp.rand(F, 6, 15, 0.4, rng)
    B = X0 @ A
    X, ok = gesv(fact, B)
    assert ok.all()
    assert X @ A == B
    # mixed: add an inconsistent row
    bad = SparseGFp.rand(F, 1, 20, 0.9, rng)
    B2 = B.vstack(bad)
    X2, ok2 = gesv(fact, B2)
    assert ok2[:6].all()
    got = (X2 @ A).to_dense()[:6]
    np.testing.assert_array_equal(got, B.to_dense())


def test_sparse_triangular_solve(rng):
    A = SparseGFp.rand(F, 18, 24, 0.2, rng)
    fact = echelonize(A)
    X0 = SparseGFp.rand(F, 5, fact.r, 0.5, rng)
    B = X0 @ fact.U
    X = sparse_triangular_solve(fact.U, B, fact.qinv)
    assert X is not None
    assert X @ fact.U == B
    # via the LU object
    X2 = sparse_triangular_solve(fact, B)
    assert X2 == X
    # unsolvable: a row with support in a free column direction outside
    if fact.r < 24:
        free = int(np.flatnonzero(fact.qinv < 0)[0])
        bad = SparseGFp.from_coo(F, 1, 24, [0], [free], [1])
        # reduce bad against U: residual stays at free col -> no solution
        assert sparse_triangular_solve(fact.U, bad, fact.qinv) is None


def test_echelonize_opts_api():
    A = SparseGFp.from_dense([[1, 2], [3, 6]], 42013)
    fact = echelonize(A, min_pivot_proportion=0.5, max_round=2,
                      dense_block_size=10)
    assert fact.r == 1
    with pytest.raises(TypeError):
        echelonize(A, not_an_option=1)


def test_complete_rref():
    A = SparseGFp.from_dense([[1, 2, 3], [2, 4, 7], [0, 0, 1]], 42013)
    fact = echelonize(A, complete=True)
    assert fact.complete
    # U is now itself the canonical RREF
    assert fact.U == rref_of_U(echelonize(A))


def test_gplu_path(rng):
    # force the GPLU finish by disabling dense
    A = SparseGFp.rand(F, 30, 30, 0.1, rng)
    f1 = echelonize(A, enable_dense=False, max_round=1)
    f2 = echelonize(A)
    assert f1.r == f2.r == dense_rank_oracle(F.p, A.to_dense())
    assert rref_of_U(f1) == rref_of_U(f2)
    check_fact(A, f1)


def test_dense_only_path(rng):
    A = SparseGFp.rand(F, 30, 30, 0.1, rng)
    f1 = echelonize(A, max_round=0)  # straight to dense finish
    assert f1.r == dense_rank_oracle(F.p, A.to_dense())
    check_fact(A, f1)


def test_large_prime_end_to_end(rng):
    p = 2**31 - 1
    fp = field(p)
    A = SparseGFp.rand(fp, 12, 15, 0.3, rng)
    fact = echelonize(A)
    assert fact.r == dense_rank_oracle(p, A.to_dense())
    k = kernel(fact)
    assert (A @ k.T).nnz == 0


def test_complete_with_L_solve(rng):
    # complete facts use canonical RREF pivots (may differ from the
    # factorization's); L, solve and gesv must stay consistent
    A = SparseGFp.rand(F, 25, 30, 0.15, rng)
    fc = echelonize(A, complete=True, L=True)
    assert fc.L @ fc.U == A
    x0 = F.rand(25, rng)
    b = A.xapy(x0)
    x = solve(fc, b)
    assert x is not None and np.array_equal(A.xapy(x), b)
    X0 = SparseGFp.rand(F, 3, 25, 0.5, rng)
    B = X0 @ A
    X, ok = gesv(fc, B)
    assert ok.all() and X @ A == B


def test_rref_canonical_under_any_pivots(rng):
    # the canonical RREF must not depend on which pivot set the
    # factorization happened to choose (non-leftmost pivots included)
    from spasm_tpu.solve import rref_of_U

    for seed in range(3):
        r2 = np.random.default_rng(seed)
        A = SparseGFp.rand(F, 24, 28, 0.12, r2)
        facts = [echelonize(A), echelonize(A, max_round=0),
                 echelonize(A, enable_greedy_pivot_search=False),
                 echelonize(A, max_round=1, dense_block_size=8)]
        rs = [rref_of_U(x) for x in facts]
        assert all(x == rs[0] for x in rs[1:])


def test_adversarial_cascade_tail(rng):
    # Pathological GPLU tail: row i has support {0..i} (a dense cascade —
    # each FL round alone would harvest ONE pivot, degrading to O(n)
    # rounds).  The fractional-insertion greedy resolves the whole chain
    # in a bounded number of waves; enable_dense=False forces the sparse
    # machinery to handle it end to end.
    import scipy.sparse as sp

    n = 300
    ii = np.concatenate([np.full(i + 1, i) for i in range(n)])
    jj = np.concatenate([np.arange(i + 1) for i in range(n)])
    vv = np.ones(ii.size, np.int64)
    A = SparseGFp.from_scipy(
        sp.csr_matrix((vv, (ii, jj)), shape=(n, n)), F.p)
    fact = echelonize(A, enable_dense=False)
    assert fact.r == n
    check_fact(A, fact)


def test_gplu_adversarial_dense_block(rng, monkeypatch):
    # A structure that defeats EVERY batched strategy: a dense residue.
    # All row pairs interact, so no two pivots are mutually insertable in
    # one pass — FL + FL-cols + fractional greedy all degrade to ~1
    # pivot/round, i.e. Theta(n) full sweeps.  The lean-round detector
    # must hand the residue to the per-row left-looking _gplu_sequential
    # (the reference's GPLU, src/SpaSM.jl:694-722) and finish in one pass.
    import importlib

    # the package rebinds the attribute `spasm_tpu.echelonize` to the
    # function; go through importlib for the module itself
    ech = importlib.import_module("spasm_tpu.echelonize")
    engaged = {}
    orig = ech._gplu_sequential

    def spy(*a, **kw):
        engaged["yes"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(ech, "_gplu_sequential", spy)
    n = 120
    A = SparseGFp.from_scipy(
        __import__("scipy.sparse", fromlist=["csr_matrix"]).csr_matrix(
            F.rand((n, n), rng).astype(np.int64)), F.p)
    fact = echelonize(A, enable_dense=False)
    assert engaged.get("yes"), "sequential GPLU fallback did not engage"
    fact_dense = echelonize(A, enable_dense=True)
    assert fact.r == fact_dense.r
    assert rref_of_U(fact) == rref_of_U(fact_dense)


def test_gplu_sequential_with_L(rng):
    # the per-row fallback must also record exact L coefficients
    import scipy.sparse as sp

    n = 90
    D = F.rand((n, n), rng).astype(np.int64)
    D[rng.random((n, n)) < 0.5] = 0  # half-dense: still defeats batching
    A = SparseGFp.from_scipy(sp.csr_matrix(D), F.p)
    fact = echelonize(A, enable_dense=False, L=True)
    assert fact.L @ fact.U == A


def test_gplu_sequential_direct_parity(rng):
    # unit-level: the sequential eliminator alone reproduces rank + RREF
    # of the standard path on a random sparse matrix
    import importlib

    ech = importlib.import_module("spasm_tpu.echelonize")
    EchelonizeOptions = ech.EchelonizeOptions

    A = SparseGFp.rand(F, 140, 130, 0.05, rng)
    S = A.to_scipy()
    opts = EchelonizeOptions()
    opts = __import__("dataclasses").replace(opts, dense_budget=10**8)
    out = ech._gplu_sequential(F, S, np.arange(A.n, dtype=np.int64), 0,
                               opts, [])
    assert out is not None
    Useq, pcols, porig = out
    assert Useq.shape[0] == pcols.size == porig.size
    # unit pivots located by pcols; rank parity with echelonize
    piv_vals = np.asarray(
        Useq[np.arange(pcols.size), pcols]).ravel()
    assert (piv_vals == 1).all()
    assert pcols.size == echelonize(A).r
    # row space parity: stack U over the original rows loses no rank
    import scipy.sparse as sp

    stacked = SparseGFp.from_scipy(
        sp.csr_matrix(sp.vstack([Useq.astype(np.int64), S])), F.p)
    assert echelonize(stacked).r == pcols.size


def test_mutual_reduce_single_wave(rng):
    """mutual_reduce yields a block with no internal elimination edges and
    identical single-product elimination results (elimination.py)."""
    import scipy.sparse as sp

    from spasm_tpu.elimination import (compute_levels,
                                       eliminate_against_reduced,
                                       mutual_reduce, pivot_graph_edges,
                                       wave_eliminate)
    from spasm_tpu.pivots import find_structural_pivots
    from spasm_tpu.sputil import mod_reduce

    f = field(42013)
    A = SparseGFp.rand(f, 400, 300, 0.02, rng)
    S = mod_reduce(A.to_scipy(), f)
    Sw = SparseGFp.from_scipy(S, f.p, assume_canonical=True)
    prows, pcols, _ = find_structural_pivots(Sw)
    npiv = prows.size
    U = sp.csr_matrix(S[prows])
    pv = np.asarray(U[np.arange(npiv), pcols]).ravel().astype(np.int64)
    row_of = np.repeat(np.arange(npiv), np.diff(U.indptr))
    U.data = f.normalize(U.data * f.inv(pv)[row_of])
    Uw = SparseGFp.from_scipy(U, f.p, assume_canonical=True)
    levels = compute_levels(Uw, pcols)
    assert levels.max() >= 1  # the case must actually exercise a cascade

    Ustar, ok = mutual_reduce(f, U, pcols, levels)
    assert ok
    # no internal edges: every row zero at every other pivot column
    Uw2 = SparseGFp.from_scipy(sp.csr_matrix(Ustar), f.p)
    src, dst = pivot_graph_edges(Uw2, pcols)
    assert src.size == 0
    # unit pivots preserved
    got_piv = np.asarray(sp.csr_matrix(Ustar)[np.arange(npiv),
                                              pcols]).ravel()
    np.testing.assert_array_equal(got_piv, np.ones(npiv))
    # same row space: single-product elimination == wave cascade
    rest = np.setdiff1d(np.arange(400), prows)
    want, _ = wave_eliminate(f, U, pcols, levels, S[rest])
    got, C = eliminate_against_reduced(f, Ustar, pcols, S[rest],
                                       record_coeffs=True,
                                       assume_canonical=True)
    assert (want != got).nnz == 0
    # B' == B - C @ Ustar exactly
    recon = mod_reduce(S[rest] - C @ sp.csr_matrix(Ustar), f)
    assert (recon != got).nnz == 0


def test_device_sparsity_threshold_gate(monkeypatch, rng):
    """On an accelerator backend (monkeypatched), the round loop switches
    to the dense finish at device_sparsity_threshold when the dense finish
    fits the budget; with the option disabled it keeps the reference's
    sparsity_threshold gate."""
    import importlib

    ech = importlib.import_module("spasm_tpu.echelonize")

    f = field(42013)
    A = SparseGFp.rand(f, 300, 300, 0.02, rng)
    monkeypatch.setattr(ech, "_on_accelerator", lambda: True)
    logs = []
    from spasm_tpu.utils import logging as lg

    lg.set_log(logs.append)
    try:
        # threshold pushed high so only the device gate can trigger the
        # early switch
        fact1 = echelonize(A, verbose=True, sparsity_threshold=0.9,
                           device_sparsity_threshold=1e-9, max_round=3)
        switched = any("too dense" in s for s in logs)
        logs.clear()
        fact2 = echelonize(A, verbose=True, sparsity_threshold=0.9,
                           device_sparsity_threshold=None, max_round=3)
        not_switched = not any("too dense" in s for s in logs)
    finally:
        lg.set_log(None)
    assert switched and not_switched
    assert fact1.r == fact2.r  # the result is gate-invariant


def test_L_factor_reduced_rounds(rng):
    # the fast-L path: round L blocks recorded against the REDUCED pivot
    # block (upper-triangular diagonal blocks, LU.lp_order reverses them)
    from spasm_tpu.fixtures import simplex_boundary
    from spasm_tpu.solve import gesv, solve

    cases = [simplex_boundary(10, 4),                      # rounds only
             SparseGFp.rand(F, 300, 320, 0.012, rng)]      # + dense corner
    for A in cases:
        fact = echelonize(A, L=True)
        assert fact.lp_order is not None      # the path actually engaged
        assert fact.L @ fact.U == A           # exactness
        # L[p] restricted to the sparse prefix is lower-triangular with a
        # nonzero diagonal UNDER lp_order (identity order is NOT
        # triangular here — that's the point of the permutation)
        Lp = fact.L.select_rows(fact.p).to_dense()
        ds = (fact.dense_piv_start if fact.dense_piv_start is not None
              else fact.r)
        o = fact.lp_order[:ds]
        P = Lp[:ds, :ds][np.ix_(o, o)]
        assert (np.diag(P) != 0).all()
        assert not np.triu(P, 1).any()
        assert not Lp[:ds, ds:].any()
        # solve through the reversed blocks
        x0 = F.rand(A.n, rng)
        b = F.normalize(x0 @ A.to_dense().astype(np.int64))
        x = solve(fact, b)
        assert x is not None
        np.testing.assert_array_equal(
            F.normalize(x @ A.to_dense().astype(np.int64)), b)
        # sparse multi-RHS: rows of A are trivially consistent
        B = A.select_rows(np.arange(0, A.n, 7))
        X, ok = gesv(fact, B)
        assert ok.all()
        got = F.normalize(X.to_dense().astype(np.int64)
                          @ A.to_dense().astype(np.int64))
        np.testing.assert_array_equal(got, B.to_dense())


def test_accelerator_finish_gate_prefers_dense(monkeypatch, rng):
    """On an accelerator the finish density gate drops to
    device_sparsity_threshold: a knife-edge tail (density just under
    sparsity_threshold) must take the dense device finish instead of host
    GPLU, with the identical rank."""
    import importlib

    ech = importlib.import_module("spasm_tpu.echelonize")
    A = SparseGFp.rand(F, 1100, 1100, 0.03, rng)  # dens in [0.02, 0.05)
    ref = echelonize(A)  # CPU default: GPLU tail
    monkeypatch.setattr(ech, "_on_accelerator", lambda: True)
    fact = echelonize(A)
    assert fact.dense_piv_start is not None  # dense finish engaged
    assert fact.r == ref.r
    assert rref_of_U(fact) == rref_of_U(ref)


def test_auto_dense_budget_scales_with_device_memory(monkeypatch):
    import importlib

    import jax

    ech = importlib.import_module("spasm_tpu.echelonize")

    class FakeGPU:
        platform = "gpu"
        device_kind = "fake"

        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    monkeypatch.setattr(ech, "_AUTO_DENSE_BUDGET", None)
    monkeypatch.setattr(jax, "devices",
                        lambda: [FakeGPU({"bytes_limit": 60 << 30})])
    assert ech._auto_dense_budget() == int((60 << 30) * 0.35) // 4
    # no memory size is assumed for a device that reports none
    monkeypatch.setattr(ech, "_AUTO_DENSE_BUDGET", None)
    monkeypatch.setattr(jax, "devices", lambda: [FakeGPU(None)])
    with pytest.raises(RuntimeError, match="no memory limit"):
        ech._auto_dense_budget()
