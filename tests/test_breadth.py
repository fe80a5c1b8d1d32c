"""Breadth coverage: tier-B primes end to end, cycle detection, PRNG
distribution, tall solves, DM on structured patterns."""

import numpy as np
import pytest

from spasm_tpu import (SparseGFp, echelonize, field, gesv, kernel, rank,
                       solve, sparse_triangular_solve)

F = field(42013)


def test_tier_b_full_pipeline(rng):
    # p >= 2**17: device fast path unavailable, tier-B/host paths engage
    p = 2**31 - 1
    fp = field(p)
    A = SparseGFp.rand(fp, 30, 34, 0.12, rng)
    fact = echelonize(A, L=True)
    assert fact.L @ fact.U == A
    K = kernel(fact)
    assert (A @ K.T).nnz == 0
    x0 = fp.rand(30, rng)
    b = A.xapy(x0)
    x = solve(fact, b)
    assert x is not None and np.array_equal(A.xapy(x), b)


def test_triangular_solve_detects_cycles():
    # a "U" whose pivot set has an alternating cycle must be rejected
    d = np.array([[1, 2], [3, 1]], dtype=np.int64)
    U = SparseGFp.from_dense(d, 42013)
    qinv = np.array([0, 1], np.int64)  # row 0 pivots col 0, row 1 col 1
    B = SparseGFp.from_dense([[1, 1]], 42013)
    with pytest.raises(ValueError):
        sparse_triangular_solve(U, B, qinv)


def test_prng_distribution():
    from spasm_tpu.certificate import SpasmPRNG

    prng = SpasmPRNG.simple(42013, 99)
    vals = prng.zzp_vector(20000)
    # coarse uniformity: mean near 0, both halves populated
    assert abs(vals.mean()) < 42013 * 0.02
    hist, _ = np.histogram(vals, bins=10,
                           range=(-(42013 // 2), 42013 // 2))
    assert hist.min() > 1500  # each decile populated


def test_tall_solve_roundtrip(rng):
    A = SparseGFp.rand(F, 120, 15, 0.2, rng)
    fact = echelonize(A, L=True, tall_and_skinny_ratio=2.0,
                      dense_block_size=32)
    assert fact.L @ fact.U == A
    X0 = SparseGFp.rand(F, 4, 120, 0.2, rng)
    B = X0 @ A
    X, ok = gesv(fact, B)
    assert ok.all() and X @ A == B


def test_wide_matrix_kernel(rng):
    A = SparseGFp.rand(F, 8, 200, 0.1, rng)
    K = kernel(A)
    assert K.shape[0] == 200 - rank(A)
    assert (A @ K.T).nnz == 0


def test_dm_on_block_diagonal(rng):
    from spasm_tpu.graphs import dulmage_mendelsohn

    # two square blocks -> square part contains everything, fine blocks
    # respect the split
    a = SparseGFp.rand(F, 4, 4, 0.9, rng).to_dense()
    b = SparseGFp.rand(F, 3, 3, 0.9, rng).to_dense()
    d = np.zeros((7, 7), np.int64)
    d[:4, :4] = a
    d[4:, 4:] = b
    A = SparseGFp.from_dense(d, 42013)
    dm = dulmage_mendelsohn(A)
    P = A.to_dense()[dm.p][:, dm.q]
    for k in range(dm.nb):
        assert not P[dm.r[k + 1]:, dm.c[k]:dm.c[k + 1]].any()


def test_getitem_negative_absent():
    A = SparseGFp.from_dense([[0, 5], [0, 0]], 42013)
    assert A[0, 0] == 0 and A[0, 1] == 5 and A[1, 1] == 0


def test_scale_by_zero(rng):
    A = SparseGFp.rand(F, 5, 5, 0.5, rng)
    Z = A * 0
    assert Z.nnz == 0 and Z.shape == (5, 5)
    assert (A * 42013).nnz == 0  # p == 0 mod p


def test_tier_b_pipeline_at_size(rng):
    # tier-B prime at a real size (previously only 30x34):
    # multi-round sparse + dense finish, validated against the structural
    # rank upper bound and host-vs-device-sparse-Schur parity
    f2 = field(2147483629)
    A = SparseGFp.rand(f2, 800, 800, 0.005, rng)
    r_host = rank(A)
    r_dev = rank(A, device_sparse_min_nnz=1)  # sparse_device waves
    assert r_host == r_dev
    from spasm_tpu.graphs import structural_rank

    assert r_host <= structural_rank(A)


def test_tier_c_device_rref_pipeline(rng):
    """Full-range prime (2**32 - 5, tier 'c') through the device dense
    RREF machinery (XLA panel loop) and the public rank/kernel path."""
    from spasm_tpu.ops import dense as dense_ops

    p = 4294967291
    f = field(p)
    X = f.rand((96, 80), rng)
    X[rng.random((96, 80)) > 0.3] = 0
    out = dense_ops.rref(f, X, host_cutoff=0)  # force the device path
    want = dense_ops._host_rref(f, X, False)
    assert out["rank"] == want["rank"]
    np.testing.assert_array_equal(out["piv_cols"], want["piv_cols"])
    np.testing.assert_array_equal(out["R"][out["piv_rows"]],
                                  want["R"][want["piv_rows"]])
    A = SparseGFp.from_dense(X, p)
    assert rank(A) == want["rank"]
    K = kernel(A)
    assert K.shape == (80 - want["rank"], 80)
    prod = (A.to_dense().astype(object)
            @ K.to_dense().T.astype(object)) % p
    assert not prod.any()
