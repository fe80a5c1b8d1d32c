"""Dense blocked Jordan RREF vs a straightforward python/NumPy oracle."""

import numpy as np
import pytest

from spasm_tpu.field import Field, field
from spasm_tpu.ops.dense import rref


def oracle_rref(p, X):
    """Textbook Gauss-Jordan RREF mod p.  Returns (rank, R_sorted, piv_cols)
    where R_sorted stacks the pivot rows in pivot-column order — the
    canonical (unique) RREF."""
    f = Field(p)
    X = f.to_unsigned(f.normalize(np.asarray(X))).astype(object) % p
    n, m = X.shape
    rank = 0
    piv_cols = []
    for j in range(m):
        hit = None
        for i in range(rank, n):
            if X[i, j] % p != 0:
                hit = i
                break
        if hit is None:
            continue
        X[[rank, hit]] = X[[hit, rank]]
        X[rank] = (X[rank] * pow(int(X[rank, j]), p - 2, p)) % p
        for i in range(n):
            if i != rank and X[i, j] % p:
                X[i] = (X[i] - X[i, j] * X[rank]) % p
        piv_cols.append(j)
        rank += 1
    R = f.normalize(X[:rank].astype(np.int64) if rank else np.zeros((0, m), np.int64))
    return rank, np.asarray(R, np.int64), piv_cols


def run_case(p, X, panel=8, want_transform=False):
    f = field(p)
    out = rref(f, X, want_transform=want_transform, panel=panel)
    rank, R_oracle, piv_cols = oracle_rref(p, X)
    assert out["rank"] == rank
    np.testing.assert_array_equal(out["piv_cols"], piv_cols)
    got_U = out["R"][out["piv_rows"]] if rank else np.zeros((0, X.shape[1]))
    np.testing.assert_array_equal(got_U.astype(np.int64), R_oracle)
    # non-pivot rows of R are identically zero
    mask = np.ones(X.shape[0], bool)
    mask[out["piv_rows"]] = False
    assert not out["R"][mask].any()
    # qinv semantics
    qinv = out["qinv"]
    for k, j in enumerate(piv_cols):
        assert qinv[j] == k
    assert (qinv[np.setdiff1d(np.arange(X.shape[1]), piv_cols)] == -1).all()
    if want_transform:
        f_ = field(p)
        prod = f_.normalize(
            out["T"].astype(object) @ f_.normalize(X).astype(object))
        np.testing.assert_array_equal(prod.astype(np.int64),
                                      out["R"].astype(np.int64))
    return out


@pytest.mark.parametrize("p", [5, 42013, 104729])
def test_random_square(p, rng):
    X = field(p).rand((20, 20), rng)
    run_case(p, X)


def test_rank_deficient(rng):
    f = field(42013)
    A = f.rand((10, 4), rng)
    B = f.rand((4, 12), rng)
    X = f.normalize(A @ B)  # rank <= 4
    out = run_case(42013, X)
    assert out["rank"] <= 4


def test_with_zero_columns(rng):
    f = field(42013)
    X = f.rand((9, 12), rng)
    X[:, [0, 3, 7]] = 0
    run_case(42013, X)


def test_tall_and_wide(rng):
    f = field(42013)
    run_case(42013, f.rand((40, 7), rng))
    run_case(42013, f.rand((7, 40), rng))


def test_zero_matrix():
    out = run_case(42013, np.zeros((5, 6), np.int64))
    assert out["rank"] == 0


def test_identity():
    out = run_case(42013, np.eye(7, dtype=np.int64))
    assert out["rank"] == 7


def test_transform(rng):
    f = field(42013)
    X = f.rand((12, 15), rng)
    run_case(42013, X, want_transform=True)


def test_transform_rank_deficient(rng):
    f = field(42013)
    A = f.rand((9, 3), rng)
    B = f.rand((3, 9), rng)
    run_case(42013, f.normalize(A @ B), want_transform=True)


def test_panel_sizes(rng):
    f = field(42013)
    X = f.rand((17, 23), rng)
    for panel in [4, 8, 16, 64]:
        run_case(42013, X, panel=panel)


def test_duplicate_rows(rng):
    f = field(42013)
    row = f.rand((1, 8), rng)
    X = np.vstack([row, row, f.mul(row, 3), f.rand((2, 8), rng)])
    run_case(42013, X)


def test_tier_b_prime(rng):
    p = 2**31 - 1
    X = field(p).rand((8, 9), rng)
    run_case(p, X)


@pytest.mark.parametrize("group", [2, 4])
def test_grouped_panels_neumann(rng, group):
    # the grouped-panel path (device default) resolves corrected pivot
    # rows once per group via the exact Neumann inverse; force it on CPU
    # and check bit-exactness against the oracle, incl. rank-deficiency
    import importlib

    dense = importlib.import_module("spasm_tpu.ops.dense")
    old = dense._FORCE_GROUP
    dense._FORCE_GROUP = group
    try:
        X = field(42013).rand((70, 90), rng).astype(np.int64)
        X[rng.random(X.shape) > 0.6] = 0
        X[5] = X[9]          # duplicate rows -> deficiency
        X[:, 11] = 0
        run_case(42013, X, panel=8)
        run_case(42013, X, panel=8, want_transform=True)
        # tier-B prime through the grouped path too
        Y = field(104729).rand((40, 56), rng).astype(np.int64)
        run_case(104729, Y, panel=8)
    finally:
        dense._FORCE_GROUP = old


def test_fused_blocked_finish_chunked(rng):
    # the single-dispatch fused finish with its dynamic K/M-chunked
    # eliminate / back-eliminate (KC=1024): cross the chunk boundary
    # (r_d > KC) and include rank deficiency, vs the plain rref oracle
    import jax.numpy as jnp

    from spasm_tpu.ops import dense as dense_ops

    f = field(42013)
    n, m = 400, 384
    X = f.rand((n, m), rng).astype(np.int64)
    X[300:] = f.normalize(X[:100] * 7)      # dependent tail rows
    coo_r, coo_c = np.nonzero(X)
    vals = X[coo_r, coo_c]
    bs = 128
    n_pad = -(-n // bs) * bs
    old_kc = dense_ops._FUSED_KC
    dense_ops._FUSED_KC = 128       # r_d = 300 crosses 2 chunk boundaries
    try:
        Ud, pc_map, r_d, ranks, prows, pcols = (
            dense_ops.fused_blocked_finish(
                f, (n_pad, m), m, bs, 128,
                jnp.asarray(coo_r, jnp.int32), jnp.asarray(coo_c, jnp.int32),
                jnp.asarray(vals, jnp.int32)))
    finally:
        dense_ops._FUSED_KC = old_kc
    r_d = int(r_d)
    assert r_d == 300
    piv_cols_loc = []
    ranks = np.asarray(ranks)
    pcols = np.asarray(pcols)
    for b in np.flatnonzero(ranks):
        piv_cols_loc.extend(pcols[b, : int(ranks[b])].tolist())
    U = dense_ops.extract_u_csr(Ud, pc_map, r_d, m, piv_cols_loc).toarray()
    # canonical mutual-RREF: rows sorted by pivot col must equal oracle
    # (oracle object values may be negative representatives — re-mod both)
    order = np.argsort(piv_cols_loc)
    got = f.to_unsigned(f.normalize(U[order])) % f.p
    rank_o, R_o, pc_o = oracle_rref(42013, X)
    assert rank_o == r_d
    assert (np.sort(piv_cols_loc) == pc_o).all()
    assert (got == R_o % f.p).all()


@pytest.mark.parametrize("p", [104729, 16777213, 2147483629])
def test_panel_eliminate_matches_host(p, rng):
    # one XLA panel step == the host Jordan RREF of that panel (same
    # first-candidate pivot rule), and its correction G reproduces it:
    # P_final == P + G @ P[prows] (mod p)
    import jax.numpy as jnp

    from spasm_tpu.ops.dense import _host_rref, _panel_eliminate

    f = field(p)
    n, c = 48, 16
    P = f.rand((n, c), rng)
    P[3, 0] = 0
    P[10, :] = 0
    Pf, G, prows, pcols, found, ispiv = (np.asarray(x) for x in
                                         _panel_eliminate(
        f, jnp.asarray(P, jnp.int32), jnp.zeros(n, bool), 0, c))
    want = _host_rref(f, P, False)
    r = want["rank"]
    assert int(found.sum()) == r and found[:r].all()
    np.testing.assert_array_equal(prows[:r], want["piv_rows"])
    np.testing.assert_array_equal(pcols[:r], want["piv_cols"])
    np.testing.assert_array_equal(Pf, want["R"])
    assert ispiv.sum() == r and ispiv[want["piv_rows"]].all()
    corr = G.astype(object)[:, :r] @ P.astype(object)[prows[:r]]
    np.testing.assert_array_equal(
        f.normalize(P.astype(object) + corr).astype(np.int64), Pf)
