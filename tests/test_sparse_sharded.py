"""Row-sharded sparse Schur over the 8-device CPU mesh."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax

from spasm_tpu import SparseGFp, field
from spasm_tpu.elimination import compute_levels, wave_eliminate
from spasm_tpu.parallel.sharded import make_mesh
from spasm_tpu.parallel.sparse_sharded import (sharded_fl_election,
                                               sharded_sparse_eliminate,
                                               shard_rows)
from spasm_tpu.pivots import find_structural_pivots, fl_row_pivots

F = field(42013)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


def make_case(rng, n=64, m=70, density=0.08):
    A = SparseGFp.rand(F, n, m, density, rng)
    prows, pcols, _ = find_structural_pivots(A)
    npiv = prows.size
    S = A.to_scipy()
    Up = sp.csr_matrix(S[prows])
    vals = np.asarray(Up[np.arange(npiv), pcols]).ravel()
    scales = F.inv(vals)
    row_of = np.repeat(np.arange(npiv), np.diff(Up.indptr))
    Up.data = F.normalize(Up.data * scales[row_of])
    U = SparseGFp.from_scipy(Up, F.p)
    levels = compute_levels(U, pcols)
    rest = np.setdiff1d(np.arange(n), prows)
    B = SparseGFp.from_scipy(sp.csr_matrix(S[rest]), F.p)
    return U, pcols, levels, B


def test_sharded_matches_host(mesh, rng):
    U, pcols, levels, B = make_case(rng)
    got = sharded_sparse_eliminate(F, mesh, U, pcols, levels, B)
    assert got is not None
    want_sp, _ = wave_eliminate(F, U.to_scipy(), pcols, levels,
                                B.to_scipy())
    assert got == SparseGFp.from_scipy(want_sp, F.p)
    assert not np.isin(got.indices, pcols).any()


def test_sharded_shard_count_invariant(rng):
    U, pcols, levels, B = make_case(rng, 48, 50, 0.1)
    results = []
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(nd)
        out = sharded_sparse_eliminate(F, mesh, U, pcols, levels, B)
        assert out is not None
        results.append(out)
    assert all(r == results[0] for r in results[1:])


def test_sharded_overflow(mesh, rng):
    U, pcols, levels, B = make_case(rng, 64, 64, 0.2)
    got = sharded_sparse_eliminate(F, mesh, U, pcols, levels, B,
                                   cap_factor=0)
    # tiny capacity either overflows (None) or still succeeds on sparse
    # shards; both acceptable — None must be reported rather than wrong data
    if got is not None:
        want_sp, _ = wave_eliminate(F, U.to_scipy(), pcols, levels,
                                    B.to_scipy())
        assert got == SparseGFp.from_scipy(want_sp, F.p)


def test_echelonize_with_mesh(mesh, rng):
    from spasm_tpu import echelonize
    from spasm_tpu.solve import rref_of_U

    A = SparseGFp.rand(F, 64, 64, 0.05, rng)
    f_mesh = echelonize(A, mesh=mesh)
    f_host = echelonize(A)
    assert f_mesh.r == f_host.r
    assert rref_of_U(f_mesh) == rref_of_U(f_host)


def test_shard_rows_roundtrip(rng):
    B = SparseGFp.rand(F, 37, 29, 0.11, rng)
    rows_l, cols_l, vals_l, per = shard_rows(B, 4, 1 << 9)
    ii, jj, vv = [], [], []
    for s in range(4):
        keep = rows_l[s] < per
        ii.append(rows_l[s][keep].astype(np.int64) + s * per)
        jj.append(cols_l[s][keep])
        vv.append(vals_l[s][keep])
    got = SparseGFp.from_coo(F, B.n, B.m, np.concatenate(ii),
                             np.concatenate(jj), np.concatenate(vv),
                             sum_duplicates=False)
    assert got == B


@pytest.mark.parametrize("n,m,d", [(64, 70, 0.08), (120, 90, 0.04)])
def test_fl_election_matches_host(mesh, rng, n, m, d):
    A = SparseGFp.rand(F, n, m, d, rng)
    dr, dc = sharded_fl_election(F, mesh, A)
    hr, hc = fl_row_pivots(A)
    np.testing.assert_array_equal(dr, hr)
    np.testing.assert_array_equal(dc, hc)


def test_fl_election_shard_count_invariant(rng):
    from spasm_tpu.fixtures import simplex_boundary

    A = simplex_boundary(9, 4)  # structured: FL finds most pivots
    hr, hc = fl_row_pivots(A)
    for nd in (1, 2, 4, 8):
        dr, dc = sharded_fl_election(F, make_mesh(nd), A)
        np.testing.assert_array_equal(dr, hr)
        np.testing.assert_array_equal(dc, hc)


def test_echelonize_mesh_uses_device_election(mesh, rng):
    # end-to-end: the mesh path (device election + sharded Schur) agrees
    # with the host path on rank and canonical RREF
    from spasm_tpu import echelonize
    from spasm_tpu.solve import rref_of_U

    A = SparseGFp.rand(F, 96, 80, 0.05, rng)
    f_mesh = echelonize(A, mesh=mesh)
    f_host = echelonize(A)
    assert f_mesh.r == f_host.r
    assert rref_of_U(f_mesh) == rref_of_U(f_host)


def test_echelonize_device_sparse_rounds(rng):
    from spasm_tpu import echelonize
    from spasm_tpu.solve import rref_of_U

    A = SparseGFp.rand(F, 70, 80, 0.06, rng)
    f_dev = echelonize(A, device_sparse_min_nnz=1)
    f_host = echelonize(A)
    assert f_dev.r == f_host.r
    assert rref_of_U(f_dev) == rref_of_U(f_host)


@pytest.mark.parametrize("n,m,d", [(64, 70, 0.08), (120, 90, 0.04)])
def test_fl_col_election_matches_host(mesh, rng, n, m, d):
    from spasm_tpu.parallel.sparse_sharded import sharded_fl_col_election
    from spasm_tpu.pivots import fl_col_pivots

    A = SparseGFp.rand(F, n, m, d, rng)
    hr, hc = fl_row_pivots(A)
    cs_h = np.zeros(m, bool); ru_h = np.zeros(n, bool)
    cs_h[hc] = True; ru_h[hr] = True
    cs_d, ru_d = cs_h.copy(), ru_h.copy()
    gr_h, gc_h = fl_col_pivots(A, cs_h, ru_h)
    gr_d, gc_d = sharded_fl_col_election(F, mesh, A, cs_d, ru_d)
    np.testing.assert_array_equal(gr_d, gr_h)
    np.testing.assert_array_equal(gc_d, gc_h)
    np.testing.assert_array_equal(cs_d, cs_h)
    np.testing.assert_array_equal(ru_d, ru_h)


def test_fl_col_election_shard_count_invariant(rng):
    from spasm_tpu.parallel.sparse_sharded import sharded_fl_col_election
    from spasm_tpu.pivots import fl_col_pivots

    A = SparseGFp.rand(F, 90, 110, 0.05, rng)
    hr, hc = fl_row_pivots(A)
    cs0 = np.zeros(110, bool); ru0 = np.zeros(90, bool)
    cs0[hc] = True; ru0[hr] = True
    cs_h, ru_h = cs0.copy(), ru0.copy()
    gr_h, gc_h = fl_col_pivots(A, cs_h, ru_h)
    for nd in (1, 2, 4, 8):
        cs_d, ru_d = cs0.copy(), ru0.copy()
        gr_d, gc_d = sharded_fl_col_election(F, make_mesh(nd), A, cs_d,
                                             ru_d)
        np.testing.assert_array_equal(gr_d, gr_h)
        np.testing.assert_array_equal(gc_d, gc_h)
        np.testing.assert_array_equal(cs_d, cs_h)


@pytest.mark.parametrize("nd", [3, 5, 6])
def test_elections_non_power_of_two_meshes(rng, nd):
    # shard_rows + both device elections on meshes that don't divide the
    # row count evenly
    from spasm_tpu.parallel.sparse_sharded import sharded_fl_col_election
    from spasm_tpu.pivots import fl_col_pivots

    A = SparseGFp.rand(F, 101, 87, 0.06, rng)
    hr, hc = fl_row_pivots(A)
    mesh = make_mesh(nd)
    dr, dc = sharded_fl_election(F, mesh, A)
    np.testing.assert_array_equal(dr, hr)
    np.testing.assert_array_equal(dc, hc)
    cs_h = np.zeros(87, bool); ru_h = np.zeros(101, bool)
    cs_h[hc] = True; ru_h[hr] = True
    cs_d, ru_d = cs_h.copy(), ru_h.copy()
    gr_h, gc_h = fl_col_pivots(A, cs_h, ru_h)
    gr_d, gc_d = sharded_fl_col_election(F, mesh, A, cs_d, ru_d)
    np.testing.assert_array_equal(gr_d, gr_h)
    np.testing.assert_array_equal(gc_d, gc_h)


def test_mesh_echelonize_boundary_1m():
    """The mesh sparse path at >= 1M nnz — full mesh
    echelonize of the d7 boundary on 20 vertices (125,970 x 77,520,
    1,007,760 nnz) over the 8-device emulation mesh, exact rank.  (The
    full d7-on-22 case, 2.56M nnz, was run once at 2/4/8 shards — rank
    116,280 at every shard count, walls 255/94/101 s — on CPU-emulated
    devices (git history); this in-suite case keeps the scale coverage without the
    multi-minute wall.)"""
    from math import comb

    from spasm_tpu import echelonize
    from spasm_tpu.fixtures import simplex_boundary

    mesh = make_mesh(8)
    A = simplex_boundary(20, 7)
    assert A.nnz == 1_007_760
    fact = echelonize(A, mesh=mesh)
    assert fact.r == comb(19, 7)
