"""Irregular structured fixtures: random subcomplex
boundaries, zipf-skewed rows, mixed-density block matrices — rank/kernel/
certificate invariants off the uniform-boundary happy path."""

import numpy as np
import pytest

import spasm_tpu as st
from spasm_tpu.fixtures import (mixed_block_matrix, simplex_boundary,
                                subcomplex_boundary, zipf_sparse)

from test_echelonize import dense_rank_oracle


def test_subcomplex_full_keep_matches_simplex():
    A = subcomplex_boundary(9, 3, keep=1.0, seed=0)
    B = simplex_boundary(9, 3)
    assert A == B


def test_subcomplex_rank_oracle_small():
    for seed in (0, 1, 2):
        A = subcomplex_boundary(8, 2, keep=0.7, seed=seed)
        assert A.shape[0] > 0 and A.nnz > 0
        fact = st.echelonize(A)
        assert fact.r == dense_rank_oracle(A.prime, A.to_dense())


def test_subcomplex_irregular_column_weights():
    A = subcomplex_boundary(12, 4, keep=0.75, seed=3)
    colw = np.bincount(A.indices, minlength=A.shape[1])
    # full simplex: every k-face has exactly n-k-1 cofaces; the deletion
    # must have produced a genuine spread
    assert colw.max() > colw[colw > 0].min()
    assert np.unique(colw).size > 3


def test_subcomplex_kernel_and_certificate():
    A = subcomplex_boundary(10, 3, keep=0.8, seed=7)
    fact = st.echelonize(A)
    K = st.kernel(A)
    assert K.shape == (A.shape[1] - fact.r, A.shape[1])
    # kernel rows k satisfy A @ k^T == 0 (reference row convention)
    assert (A @ K.transpose()).nnz == 0
    h = st.matrix_hash(A)
    cert = st.certificate_rank_create(A, h)
    assert st.certificate_rank_verify(A, h, cert)


def test_zipf_rank_oracle_and_skew():
    f = st.field(42013)
    A = zipf_sparse(f, 40, 30, mean_nnz=4.0, seed=5)
    assert st.rank(A) == dense_rank_oracle(f.p, A.to_dense())
    big = zipf_sparse(f, 4000, 2000, mean_nnz=6.0, seed=6)
    w = big.row_lengths()
    assert w.max() >= 4 * np.median(w)  # genuinely skewed


@pytest.mark.parametrize("p", [42013, 2**31 - 19])
def test_mixed_block_two_paths_and_certificate(p):
    A = mixed_block_matrix(p, seed=11)
    f1 = st.echelonize(A)
    f2 = st.echelonize(A, enable_greedy_pivot_search=False,
                       enable_dense=False)
    assert f1.r == f2.r
    h = st.matrix_hash(A)
    cert = st.certificate_rank_create(A, h)
    assert st.certificate_rank_verify(A, h, cert)
    K = st.kernel(A)
    assert K.shape == (A.shape[1] - f1.r, A.shape[1])
    assert (A @ K.transpose()).nnz == 0


def test_mixed_block_lu_roundtrip():
    A = mixed_block_matrix(42013, seed=2)
    fact = st.echelonize(A, L=True)
    assert fact.L @ fact.U == A


def test_pivot_fill_filter_rank_invariant():
    """The Markowitz fill filter (pivot_fill_filter) only re-orders WHEN
    pivots eliminate — rank/RREF must match the unfiltered path."""
    import spasm_tpu as st
    from spasm_tpu.solve import rref_of_U

    A = subcomplex_boundary(16, 5, keep=0.75, seed=2)
    fact_on = st.echelonize(A)  # default: filter armed
    fact_off = st.echelonize(A, pivot_fill_filter=None)
    assert fact_on.r == fact_off.r
    assert rref_of_U(fact_on) == rref_of_U(fact_off)
