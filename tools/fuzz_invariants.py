#!/usr/bin/env python
"""Randomized cross-validation sweep against a big-int oracle.

For ``--cases N`` (default 120) random (n, m, density, p) draws across
all arithmetic tiers (p in {3, 5, 257, 42013, 65537, 92681, 2147483629,
4294967291}), checks five end-to-end invariants through the public API:

  1. rank(A) == fraction-free big-int Gauss oracle
  2. echelonize(A, L=True):  L @ U == A  (mod p, dense object-int check)
  3. kernel(A): shape (m - r, m) and A @ K.T == 0
  4. certificate round-trip: create then verify == True
  5. solve: b = c @ A  =>  solve(LU, b) @ A == b

Exit nonzero on any violation.  Used as release evidence beyond the
fixed pytest suite; runs on the CPU backend in ~4 min.
"""
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")

import spasm_tpu as st  # noqa: E402
from spasm_tpu.certificate import matrix_hash  # noqa: E402
from spasm_tpu.csr import SparseGFp  # noqa: E402
from spasm_tpu.field import Field  # noqa: E402

PRIMES = [3, 5, 257, 42013, 65537, 92681, 2147483629, 4294967291]


def rank_oracle(M, p):
    Mat = [[int(x) % p for x in row] for row in M]
    n, m = len(Mat), len(Mat[0]) if Mat else 0
    r = 0
    for c in range(m):
        piv = next((i for i in range(r, n) if Mat[i][c] % p), None)
        if piv is None:
            continue
        Mat[r], Mat[piv] = Mat[piv], Mat[r]
        inv = pow(Mat[r][c], p - 2, p)
        Mat[r] = [(v * inv) % p for v in Mat[r]]
        for i in range(n):
            if i != r and Mat[i][c]:
                ci = Mat[i][c]
                Mat[i] = [(a - ci * b) % p for a, b in zip(Mat[i], Mat[r])]
        r += 1
        if r == n:
            break
    return r


def main():
    cases = 120
    seed = 12345
    for a in sys.argv[1:]:
        if a.startswith("--cases"):
            cases = int(a.split("=")[1] if "=" in a else sys.argv[
                sys.argv.index(a) + 1])
        if a.startswith("--seed"):
            seed = int(a.split("=")[1])
    rng = np.random.default_rng(seed)
    for trial in range(cases):
        p = PRIMES[trial % len(PRIMES)]
        f = Field(p)
        n = int(rng.integers(5, 140))
        m = int(rng.integers(5, 140))
        d = float(rng.uniform(0.01, 0.35))
        A = SparseGFp.rand(f, n, m, d, rng)
        Ad = A.to_scipy().toarray().astype(object)
        rk_o = rank_oracle(Ad.tolist(), p)
        rk = st.rank(A)
        assert rk == rk_o, (trial, p, n, m, d, rk, rk_o)
        lu = st.echelonize(A, L=True)
        assert lu.r == rk_o
        prod = (lu.L.to_scipy().toarray().astype(object)
                @ lu.U.to_scipy().toarray().astype(object) - Ad) % p
        assert not prod.any(), (trial, p)
        K = st.kernel(A)
        assert K.shape == (m - rk_o, m)
        kk = K.to_scipy().toarray().astype(object)
        assert not ((Ad @ kk.T) % p).any(), (trial, p)
        h = matrix_hash(A)
        proof = st.certificate_rank_create(A, hash_=h)
        assert st.certificate_rank_verify(A, h, proof), (trial, p)
        coeff = f.normalize(rng.integers(0, p, n))
        b = np.array((coeff.astype(object) @ Ad) % p, dtype=np.int64)
        x = st.solve(lu, b)
        assert x is not None, (trial, p)
        xv = (np.asarray(x, dtype=np.int64) if not hasattr(x, "toarray")
              else x.toarray().ravel())
        xb = (xv.astype(object) @ Ad) % p
        assert not ((xb - b) % p).any(), (trial, p)
        if trial % 20 == 19:
            print(f"{trial + 1}/{cases} cases OK", flush=True)
    print(f"FUZZ PASS: {cases} randomized cases, all 5 invariants hold")


if __name__ == "__main__":
    main()
