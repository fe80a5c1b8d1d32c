"""ZZp scalar, device SpMV, native parser, tall-and-skinny finish."""

import io

import numpy as np
import pytest

import spasm_tpu as st
from spasm_tpu import SparseGFp, ZZp, field

F = field(42013)


def test_zzp_scalar():
    a = ZZp(3, F)
    b = ZZp(42012, F)
    assert b.v == -1
    assert (a * b).v == -3
    assert (a + b).v == 2
    assert (a - b).v == 4
    assert (-a).v == -3
    assert (a / a).v == 1
    assert a.inv() * a == ZZp(1, F)
    assert b.lift() == 42012
    assert int(a) == 3
    with pytest.raises(ValueError):
        a + ZZp(1, field(65537))


def test_device_spmv(rng):
    from spasm_tpu.ops.spmv import DeviceCOO, axpy, xapy

    A = SparseGFp.rand(F, 30, 40, 0.2, rng)
    D = DeviceCOO.from_csr(A)
    x = F.rand(30, rng)
    np.testing.assert_array_equal(np.asarray(xapy(D, x)), A.xapy(x))
    z = F.rand(40, rng)
    np.testing.assert_array_equal(np.asarray(axpy(D, z)), A.axpy(z))
    y = F.rand(40, rng)
    np.testing.assert_array_equal(np.asarray(xapy(D, x, y)), A.xapy(x, y))


def test_native_parser_roundtrip(rng):
    from spasm_tpu.native import parse_sms_native

    A = SparseGFp.rand(F, 50, 60, 0.1, rng)
    data = st.dumps_sms(A)
    parsed = parse_sms_native(data)
    if parsed is None:
        pytest.skip("no C compiler available")
    n, m, i, j, v = parsed
    assert (n, m) == (50, 60)
    B = SparseGFp.from_coo(F, n, m, i - 1, j - 1, v)
    assert B == A


def test_native_parser_negative_and_noise():
    from spasm_tpu.native import parse_sms_native

    raw = b"3 4 M\n1 1 -7\n2 3 42013\n0 0 0\ngarbage after end\n"
    parsed = parse_sms_native(raw)
    if parsed is None:
        pytest.skip("no C compiler available")
    n, m, i, j, v = parsed
    assert (n, m) == (3, 4)
    assert list(v) == [-7, 42013]


def test_tall_and_skinny_finish(rng):
    from spasm_tpu import echelonize
    from spasm_tpu.solve import rref_of_U

    # 600 rows x 20 cols, low rank: tall path must engage
    B = SparseGFp.rand(F, 600, 6, 0.5, rng)
    C = SparseGFp.rand(F, 6, 20, 0.6, rng)
    A = B @ C
    f_tall = echelonize(A, max_round=0, tall_and_skinny_ratio=2.0,
                        dense_block_size=128)
    f_ref = echelonize(A, enable_tall_and_skinny=False, max_round=0)
    assert f_tall.r == f_ref.r
    assert rref_of_U(f_tall) == rref_of_U(f_ref)


def test_tall_and_skinny_with_L(rng):
    from spasm_tpu import echelonize

    B = SparseGFp.rand(F, 300, 5, 0.5, rng)
    C = SparseGFp.rand(F, 5, 15, 0.6, rng)
    A = B @ C
    fact = echelonize(A, L=True, max_round=0, tall_and_skinny_ratio=2.0,
                      dense_block_size=64)
    assert fact.L @ fact.U == A


def test_device_blocked_finish(rng, monkeypatch):
    """Force the device-resident fused block loop (normally engaged only
    for large matrices) on the CPU backend and compare against host."""
    from spasm_tpu.ops import dense as D
    from spasm_tpu import echelonize
    from spasm_tpu.solve import rref_of_U

    A = SparseGFp.rand(F, 90, 70, 0.08, rng)
    f_host = echelonize(A, max_round=0)
    monkeypatch.setattr(D, "HOST_CUTOFF", 1)
    f_dev = echelonize(A, max_round=0, dense_block_size=32)
    assert f_dev.r == f_host.r
    assert rref_of_U(f_dev) == rref_of_U(f_host)
    # with L factor
    f_devL = echelonize(A, max_round=0, dense_block_size=32, L=True)
    assert f_devL.L @ f_devL.U == A
    # over-budget fallback: the streaming per-block loop
    monkeypatch.setattr(D, "FUSED_BUDGET", 1)
    f_str = echelonize(A, max_round=0, dense_block_size=32)
    assert f_str.r == f_host.r
    assert rref_of_U(f_str) == rref_of_U(f_host)


def test_schur_density_estimate(rng):
    import scipy.sparse as sp

    from spasm_tpu.echelonize import schur_estimate_density
    from spasm_tpu.elimination import compute_levels
    from spasm_tpu.pivots import find_structural_pivots

    A = SparseGFp.rand(F, 60, 60, 0.05, rng)
    prows, pcols, _ = find_structural_pivots(A)
    npiv = prows.size
    S = A.to_scipy()
    Up = sp.csr_matrix(S[prows])
    vals = np.asarray(Up[np.arange(npiv), pcols]).ravel()
    scales = F.inv(vals)
    row_of = np.repeat(np.arange(npiv), np.diff(Up.indptr))
    Up.data = F.normalize(Up.data * scales[row_of])
    Uw = SparseGFp.from_scipy(Up, F.p)
    levels = compute_levels(Uw, pcols)
    rest = np.setdiff1d(np.arange(60), prows)
    est = schur_estimate_density(F, Up, pcols, levels, sp.csr_matrix(S[rest]))
    assert 0.0 <= est <= 1.0


def test_human_format():
    from spasm_tpu.utils.logging import human_format

    assert human_format(999) == "999"
    assert human_format(1500) == "1.5k"
    assert human_format(2_500_000) == "2.5M"
    assert human_format(3_200_000_000) == "3.2G"


def test_greedy_mopup_unbounded_when_productive():
    """The sequential greedy mop-up continues past its batch size while
    productive (the old hard 4096-row cap could leave
    harvestable pivots to extra Schur rounds).  Star instance: row 0 =
    {0}, row i = {0, i} — FL takes one row for column 0, FL-cols is
    blocked by the column-0 hit on every row, and the fractional-
    insertion greedy can take EVERY remaining row (disjoint free
    columns).  The full harvest must land in a single round."""
    import spasm_tpu as st
    from spasm_tpu.pivots import find_structural_pivots

    n = 9000  # > 2x the old cap
    i_idx = np.concatenate([[0], np.repeat(np.arange(1, n), 2)])
    j_idx = np.concatenate(
        [[0], np.stack([np.zeros(n - 1, np.int64),
                        np.arange(1, n)], 1).ravel()])
    A = SparseGFp.from_coo(F, n, n, i_idx, j_idx,
                           np.ones(i_idx.size, np.int64))
    prows, pcols, counts = find_structural_pivots(A)
    assert prows.size == n
    assert counts["greedy"] == n - 1
    assert st.rank(A) == n


def _cache_dir_in_child(env_extra):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    code = ("import jax, spasm_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return root, out.stdout.strip().splitlines()[-1]


def test_compile_cache_default_in_checkout():
    import os

    root, got = _cache_dir_in_child({})
    assert got == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_compile_cache_env_wins(tmp_path):
    _, got = _cache_dir_in_child(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")})
    assert got == str(tmp_path / "cc")
