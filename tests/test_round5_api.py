"""Round-5 API-parity additions: B / LU operator, submatching reindexing,
notebook PNG display, native dense triangular solves, PRNG byte-convention
variants."""

import json
import os
import struct
import zlib

import numpy as np
import pytest

import spasm_tpu as st
from spasm_tpu import SparseGFp, field
from spasm_tpu.certificate import (SpasmPRNG, certificate_rank_create,
                                   certificate_rank_verify)
from spasm_tpu.echelonize import echelonize
from spasm_tpu.graphs import submatching
from spasm_tpu.io import repr_png
from spasm_tpu.solve import (dense_back_solve, dense_forward_solve,
                             sparse_triangular_solve)

F = field(42013)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "prng_vectors.json")


# ---------------- B / LU operator (src/SpaSM.jl:755) ----------------


def test_truediv_is_sparse_triangular_solve(rng):
    A = SparseGFp.rand(F, 12, 16, 0.3, rng)
    fact = echelonize(A)
    # rows of A are in the row space of U, so A / fact must solve exactly
    X = A / fact
    assert X is not None
    Xf = sparse_triangular_solve(fact, A)
    assert X == Xf
    assert X @ fact.U == A


def test_truediv_unsolvable_returns_none():
    U = SparseGFp.from_dense([[1, 2]], 42013)
    fact = echelonize(U)
    B = SparseGFp.from_dense([[0, 1]], 42013)  # not a multiple of [1, 2]
    assert (B / fact) is None


def test_truediv_wrong_operand():
    A = SparseGFp.from_dense([[1]], 42013)
    with pytest.raises(TypeError):
        A / 3


# ---------------- submatching (src/SpaSM.jl:786) ----------------


def test_submatching_reindexes():
    match = np.array([3, -1, 5, 0, 4], np.int64)
    # restrict to rows [2, 5) x cols [3, 6): partners 5, 0, 4 -> 2, -1, 1
    out = submatching(match, 2, 5, 3, 6)
    assert out.tolist() == [2, -1, 1]
    # full range with c=0 is the identity restriction
    out2 = submatching(match, 0, 5, 0, 6)
    assert out2.tolist() == [3, -1, 5, 0, 4]


def test_submatching_does_not_mutate_input():
    match = np.array([1, 2], np.int64)
    submatching(match, 0, 2, 1, 3)
    assert match.tolist() == [1, 2]


# ---------------- notebook PNG display ----------------


def _decode_png_gray(png: bytes):
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(png):
        (ln,) = struct.unpack(">I", png[pos:pos + 4])
        tag = png[pos + 4:pos + 8]
        payload = png[pos + 8:pos + 8 + ln]
        (crc,) = struct.unpack(">I", png[pos + 8 + ln:pos + 12 + ln])
        assert crc == zlib.crc32(tag + payload)
        chunks.setdefault(tag, b"")
        chunks[tag] += payload
        pos += 12 + ln
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 0)  # 8-bit grayscale
    raw = zlib.decompress(chunks[b"IDAT"])
    img = np.frombuffer(raw, np.uint8).reshape(h, w + 1)
    assert (img[:, 0] == 0).all()  # filter byte 0 per scanline
    return img[:, 1:]


def test_repr_png_roundtrip(rng):
    A = SparseGFp.rand(F, 40, 60, 0.1, rng)
    img = _decode_png_gray(A._repr_png_())
    assert img.shape == (40, 60)
    i, j, _ = A.to_coo()
    dark = img < 255
    assert dark[i, j].all()
    assert dark.sum() == A.nnz  # cells without entries stay white


def test_repr_png_downscales():
    A = SparseGFp.eye(field(42013), 1200)
    img = _decode_png_gray(repr_png(A))
    assert img.shape == (500, 500)  # reference's 500-px cap
    assert (np.diag(img) < 255).all()


# ---------------- native dense triangular solves ----------------


def _rand_lower(n, p, rng, permute=False):
    f = field(p)
    dense = f.normalize(rng.integers(-(p // 2), p // 2 + 1, (n, n)))
    dense = np.tril(dense)
    d = f.normalize(rng.integers(1, p, n))
    np.fill_diagonal(dense, d)
    perm = rng.permutation(n) if permute else np.arange(n)
    # row perm[j] carries original row j => diagonal of column j at perm[j]
    shuffled = np.zeros_like(dense)
    shuffled[perm] = dense
    return SparseGFp.from_dense(shuffled, p), perm


@pytest.mark.parametrize("p", [3, 42013, 2**31 - 19, 2**32 - 5])
def test_dense_back_solve_roundtrip(p, rng):
    f = field(p)
    L, perm = _rand_lower(25, p, rng, permute=True)
    x = f.normalize(rng.integers(-(p // 2), p // 2 + 1, 25))
    b = L.xapy(x)
    got = dense_back_solve(L, b, perm)
    assert got is not None
    assert np.array_equal(f.normalize(got), x)


@pytest.mark.parametrize("p", [42013, 2**32 - 5])
def test_dense_forward_solve_roundtrip(p, rng):
    f = field(p)
    n = 25
    dense = f.normalize(rng.integers(-(p // 2), p // 2 + 1, (n, n)))
    dense = np.triu(dense)
    np.fill_diagonal(dense, 1)
    U = SparseGFp.from_dense(dense, p)
    x = f.normalize(rng.integers(-(p // 2), p // 2 + 1, n))
    b = U.xapy(x)
    got = dense_forward_solve(U, b, np.arange(n))
    assert got is not None
    assert np.array_equal(f.normalize(got), x)


def test_dense_solves_native_matches_python_oracle(rng, monkeypatch):
    """The C port must be bit-identical to the Python loop it replaced."""
    import spasm_tpu.native as native

    p = 42013
    f = field(p)
    L, perm = _rand_lower(30, p, rng, permute=True)
    x = f.normalize(rng.integers(-(p // 2), p // 2 + 1, 30))
    b = L.xapy(x)
    fast = dense_back_solve(L, b, perm)
    bad = f.normalize(b + np.eye(30, dtype=np.int64)[0])
    fast_bad = dense_back_solve(L, bad, perm)
    monkeypatch.setattr(native, "dense_trisolve_native",
                        lambda *a, **k: NotImplemented)
    slow = dense_back_solve(L, b, perm)
    assert np.array_equal(fast, slow)
    assert fast_bad is None or np.array_equal(
        fast_bad, dense_back_solve(L, bad, perm))


def test_dense_back_solve_unsolvable(rng):
    # rank-deficient: a zero row in the "diagonal" position
    p = 42013
    L = SparseGFp.from_dense([[1, 0], [3, 0]], p)
    # column 1 has no entry at its claimed diagonal row
    assert dense_back_solve(L, np.array([0, 1]), np.array([0, 1])) is None


# ---------------- parallel SMS parser degenerate layout ----------------


def test_parallel_parser_first_triple_on_header_line():
    """A >=4MiB SMS buffer whose first triple shares the header line must
    parse identically to the sequential/NumPy tokenizers (which split
    purely by whitespace) — the parallel parser used to skip to the first
    newline and silently lose that triple."""
    from spasm_tpu.native import parse_sms_native

    k = 420_000
    rows = np.arange(1, k + 1)
    lines = [f"{i} {1 + (i % 7)} {1 + (i % 11)}" for i in rows]
    # header and FIRST triple share a line; no trailing terminator
    raw = (f"{k} 12 M {lines[0]}\n" + "\n".join(lines[1:]) + "\n").encode()
    assert len(raw) >= (1 << 22), "buffer must take the parallel path"
    parsed = parse_sms_native(raw)
    if parsed is None:
        pytest.skip("no C compiler available")
    n, m, i, j, v = parsed
    assert (n, m) == (k, 12)
    assert len(i) == k
    assert i[0] == 1 and j[0] == 2 and v[0] == 2
    assert i[-1] == k


# ---------------- PRNG byte-convention variants ----------------


def test_prng_variants_match_golden():
    with open(GOLDEN) as fh:
        data = json.load(fh)
    for case in data["cases"]:
        seed = bytes.fromhex(case["seed"])
        for variant, want in case["u32_variants_first16"].items():
            prng = SpasmPRNG(seed, case["prime"], case["seq"],
                             variant=variant)
            got = [prng.u32() for _ in range(len(want))]
            assert got == want, (variant, case["prime"])


def test_prng_variant_vector_consistency():
    # zzp_vector must equal scalar draws under every variant (the
    # non-default variants take the hashlib path; LE-STATE the native one)
    for variant in SpasmPRNG.VARIANTS:
        a = SpasmPRNG(b"\x42" * 32, 42013, 3, variant=variant)
        b = SpasmPRNG(b"\x42" * 32, 42013, 3, variant=variant)
        assert a.zzp_vector(100).tolist() == [b.zzp() for _ in range(100)]


def test_certificate_foreign_variant_verifies(rng):
    A = SparseGFp.rand(F, 15, 20, 0.3, rng)
    proof = certificate_rank_create(A, variant="BE-MEM")
    h = st.matrix_hash(A)
    assert not certificate_rank_verify(A, h, proof)  # default stream differs
    assert certificate_rank_verify(A, h, proof, variant="BE-MEM")
    # the check_cert-style sweep finds it
    assert any(certificate_rank_verify(A, h, proof, variant=v)
               for v in SpasmPRNG.VARIANTS)
