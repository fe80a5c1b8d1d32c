"""One-pass device qinv Schur (ops/sparse_onepass.py) and its per-row
sort merge: exact equality with the host eliminate_against_reduced across
all arithmetic tiers.

The host analog is csrc/schur_mod.c (the reference's scatter loop,
src/SpaSM.jl:619-621); equality is CSR-exact (same pattern, same balanced
values)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import spasm_tpu as st
from spasm_tpu import elimination as E
from spasm_tpu.csr import SparseGFp
from spasm_tpu.echelonize import _round_schur_estimate
from spasm_tpu.fixtures import subcomplex_boundary, zipf_sparse
from spasm_tpu.ops.sparse_onepass import (_onepass_class,
                                          eliminate_onepass_device)
from spasm_tpu.pivots import find_structural_pivots


def _round0(A):
    f = A.field
    S = A.to_scipy()
    prows, pcols, _ = find_structural_pivots(A)
    est, S_rest, rest_rows, blk = _round_schur_estimate(f, S, prows, pcols)
    Upart, piv_vals, levels = blk
    Ustar, ok = E.mutual_reduce(f, Upart, pcols, levels)
    assert ok
    return f, Ustar, pcols, S_rest


def _csr_equal(Dh, Dd):
    Dh = sp.csr_matrix(Dh)
    Dh.sort_indices()
    Dh.eliminate_zeros()
    return (Dh.nnz == Dd.nnz and np.array_equal(Dh.indptr, Dd.indptr)
            and np.array_equal(Dh.indices, Dd.indices)
            and np.array_equal(Dh.data, Dd.data))


@pytest.mark.parametrize("p", [3, 42013, 2**31 - 19, 2**32 - 5])
@pytest.mark.parametrize("min_class_rows", [0, 10**9])
def test_onepass_matches_host_random(p, min_class_rows, rng):
    f = st.field(p)
    for trial in range(3):
        n = int(rng.integers(30, 150))
        m = int(rng.integers(30, 150))
        A = SparseGFp.rand(f, n, m, 0.06, rng)
        prows, _, _ = find_structural_pivots(A)
        if len(prows) == 0:
            continue
        f, Ustar, pcols, S_rest = _round0(A)
        Dh, _ = E.eliminate_against_reduced(f, Ustar, pcols, S_rest,
                                            assume_canonical=True)
        Dd = eliminate_onepass_device(f, Ustar, pcols, sp.csr_matrix(S_rest),
                                      min_class_rows=min_class_rows)
        assert _csr_equal(Dh, Dd)


def test_onepass_irregular_many_classes(rng):
    """zipf rows produce many (Wb, H, Ku) classes; small ones take the
    host fallback, all results splice back exactly."""
    f = st.field(42013)
    A = zipf_sparse(f, 600, 300, mean_nnz=6.0, seed=3)
    prows, _, _ = find_structural_pivots(A)
    assert len(prows)
    f, Ustar, pcols, S_rest = _round0(A)
    Dh, _ = E.eliminate_against_reduced(f, Ustar, pcols, S_rest,
                                        assume_canonical=True)
    stats = {}
    Dd = eliminate_onepass_device(f, Ustar, pcols, sp.csr_matrix(S_rest),
                                  min_class_rows=64, _stats=stats)
    assert _csr_equal(Dh, Dd)
    assert stats["classes"] + (stats["host_fallback_rows"] > 0) >= 1


def test_onepass_row_chunking_exact():
    """A tiny max_tile_slots forces the big classes through fixed-height
    row chunks; the spliced result stays CSR-exact."""
    from spasm_tpu.fixtures import simplex_boundary

    A = simplex_boundary(14, 5)
    f, Ustar, pcols, S_rest = _round0(A)
    Dh, _ = E.eliminate_against_reduced(f, Ustar, pcols, S_rest,
                                        assume_canonical=True)
    stats = {}
    Dd = eliminate_onepass_device(f, Ustar, pcols, sp.csr_matrix(S_rest),
                                  max_tile_slots=1 << 17, min_class_rows=0,
                                  _stats=stats)
    assert Dd is not None and _csr_equal(Dh, Dd)
    assert stats["chunks"] > stats["classes"]  # chunking actually engaged


def test_onepass_mesh_sharded_exact(rng):
    """Class tiles row-sharded over a CPU mesh produce the identical
    result (SURVEY 2.11 item 1 path)."""
    import jax
    from jax.sharding import Mesh

    f = st.field(42013)
    A = SparseGFp.rand(f, 400, 250, 0.05, rng)
    prows, _, _ = find_structural_pivots(A)
    if len(prows) == 0:
        pytest.skip("no pivots")
    f, Ustar, pcols, S_rest = _round0(A)
    Dh, _ = E.eliminate_against_reduced(f, Ustar, pcols, S_rest,
                                        assume_canonical=True)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("rows",))
    Dd = eliminate_onepass_device(f, Ustar, pcols, sp.csr_matrix(S_rest),
                                  min_class_rows=0, mesh=mesh)
    assert Dd is not None and _csr_equal(Dh, Dd)
    # non-power-of-two shard counts must shard too (R_pad is padded to a
    # multiple of the shard count, not just a power of two)
    mesh6 = Mesh(np.array(jax.devices()[:6]).reshape(6), ("rows",))
    Dd6 = eliminate_onepass_device(f, Ustar, pcols, sp.csr_matrix(S_rest),
                                   min_class_rows=0, mesh=mesh6)
    assert Dd6 is not None and _csr_equal(Dh, Dd6)


def test_onepass_subcomplex_boundary():
    A = subcomplex_boundary(11, 3, keep=0.8, seed=1)
    f, Ustar, pcols, S_rest = _round0(A)
    Dh, _ = E.eliminate_against_reduced(f, Ustar, pcols, S_rest,
                                        assume_canonical=True)
    Dd = eliminate_onepass_device(f, Ustar, pcols, sp.csr_matrix(S_rest),
                                  min_class_rows=0)
    assert _csr_equal(Dh, Dd)


@pytest.mark.parametrize("p", [42013, 2**31 - 19, 2**32 - 5])
def test_onepass_sort_merge_exact(p, rng):
    """The batched per-row sort + segmented modular sum of one width
    class == brute-force per-row accumulate of B row + (-c * U rows)."""
    f = st.field(p)
    R, Wb, H, Ku, nref, m = 32, 16, 4, 8, 12, 200

    def balanced(shape):
        return rng.integers(-(p // 2), p // 2 + 1, shape).astype(np.int32)

    b_cols = rng.integers(0, m, (R, Wb)).astype(np.int32)
    b_cols[rng.random((R, Wb)) < 0.3] = m        # dead slots
    b_vals = np.where(b_cols < m, balanced((R, Wb)), 0).astype(np.int32)
    u_cols = rng.integers(0, m, (nref, Ku)).astype(np.int32)
    u_cols[rng.random((nref, Ku)) < 0.2] = m
    u_vals = np.where(u_cols < m, balanced((nref, Ku)), 0).astype(np.int32)
    hit_k = rng.integers(0, nref, (R, H)).astype(np.int32)
    hit_c = balanced((R, H))
    hit_ok = rng.random((R, H)) < 0.7
    oc, ov, keep, cnt = (np.asarray(x) for x in _onepass_class(
        f, *(jnp.asarray(x) for x in (b_cols, b_vals, hit_k, hit_c, hit_ok,
                                      u_cols, u_vals)), m))
    assert int(cnt) == int(keep.sum())
    for i in range(R):
        ref = {}
        terms = [(c, int(v)) for c, v in zip(b_cols[i], b_vals[i])]
        for h in range(H):
            if hit_ok[i, h]:
                k = hit_k[i, h]
                terms += [(c, -int(hit_c[i, h]) * int(v))
                          for c, v in zip(u_cols[k], u_vals[k])]
        for c, v in terms:
            if c != m:
                ref[c] = (ref.get(c, 0) + v) % p
        ref = {c: (v if v <= p // 2 else v - p)
               for c, v in ref.items() if v}
        got = {int(c): int(v) for c, v, k in zip(oc[i], ov[i], keep[i]) if k}
        assert got == ref
        kc = oc[i][keep[i]]
        assert (np.diff(kc) > 0).all()  # kept slots sorted by column
