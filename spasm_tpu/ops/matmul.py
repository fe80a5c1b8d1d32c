"""Exact dense matrix multiply over GF(p) on the accelerator.

This is the replacement for the reference's L1 dense layer (FFLAS-FFPACK
driven through ``spasm_ffpack.cpp``, src/SpaSM.jl:802-812): where FFPACK
uses float BLAS with delayed modular reduction, we use the exact
int8 x int8 -> int32 matrix product (integer tensor cores on the GPU)
with a balanced base-256 limb decomposition (modmul.to_limbs):

    x = sum_i l_i 256**i,   l_i in [-128, 127]  (int8)

    A @ B mod p = sum_{i,j} (A_i @ B_j) * 256**(i+j)   (mod p)

Each limb-pair diagonal D_s = sum_{i+j=s} A_i @ B_j accumulates exactly in
int32 as long as ``k_chunk * 128 * 128 * nl <= 2**30`` (`_k_chunk`); we
chunk the contraction dimension statically to guarantee this, reduce mod p
per chunk, and combine diagonals with precomputed weights ``256**s mod p``.

The number of limbs is chosen per prime (field.num_limbs — the analog of
``spasm_datatype_choose``): 1 limb for p <= 255, 2 for p <= 65279, 3 for
p <= 16711423, 4 for p <= 4278124287, 5 to the top of the legal range
(device elementwise ops cap at p < 2**31, see modmul.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..field import Field, num_limbs
from . import modmul

# Max k-chunk so that a single limb-pair product sum plus cross-diagonal
# accumulation stays below 2**31: chunk * 128*128 * nl <= 2**30.
def _k_chunk(nl: int) -> int:
    return max(128, (1 << 30) // (16384 * nl) // 128 * 128)


def modmatmul(f: Field, a, b):
    """C = a @ b (mod p), balanced int32 in, balanced int32 out.

    a: (n, k) int32, b: (k, m) int32.  Traced/jittable; `f` is static.
    The int8 limb products are plain XLA dots (XLA:GPU emits its own
    Triton int8 GEMMs for them); a fused Pallas kernel with the modular
    epilogue on chip measured slower on H100 end to end (PERF.md).
    """
    modmul.check_device_prime(f)
    nl = num_limbs(f.p)
    n, k = a.shape
    k2, m = b.shape
    assert k == k2, (a.shape, b.shape)
    chunk = _k_chunk(nl)

    al = modmul.to_limbs(f, a, nl)  # (n, k, nl) int8
    bl = modmul.to_limbs(f, b, nl)  # (k, m, nl) int8
    w = modmul.limb_weights(f, nl)  # (2nl-1,) int32 balanced

    nchunks = (k + chunk - 1) // chunk
    if nchunks > 1:
        pad = nchunks * chunk - k
        al = jnp.pad(al, ((0, 0), (0, pad), (0, 0)))
        bl = jnp.pad(bl, ((0, pad), (0, 0), (0, 0)))

    def one_chunk(al_c, bl_c):
        # diagonal sums D_s = sum_{i+j=s} A_i @ B_j, each exact in int32
        diags = [None] * (2 * nl - 1)
        for i in range(nl):
            for j in range(nl):
                prod = jax.lax.dot_general(
                    al_c[:, :, i],
                    bl_c[:, :, j],
                    (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32,
                )
                s = i + j
                diags[s] = prod if diags[s] is None else diags[s] + prod
        acc = jnp.zeros((n, m), dtype=jnp.int32)
        for s in range(2 * nl - 1):
            term = modmul.mul(f, modmul.normalize(f, diags[s]), w[s])
            acc = modmul.add(f, acc, term)
        return acc

    if nchunks == 1:
        return one_chunk(al, bl)

    al = al.reshape(n, nchunks, chunk, nl)
    bl = bl.reshape(nchunks, chunk, m, nl)

    def body(c, acc):
        return modmul.add(f, acc, one_chunk(al[:, c], bl[c]))

    return jax.lax.fori_loop(0, nchunks, body, jnp.zeros((n, m), jnp.int32))


@functools.partial(jax.jit, static_argnums=0)
def modmatmul_jit(f: Field, a, b):
    return modmatmul(f, a, b)


def modmatvec(f: Field, a, x):
    """a @ x (mod p) for a (n,k) int32, x (k,) int32."""
    return modmatmul(f, a, x[:, None])[:, 0]


def modvecmat(f: Field, x, a):
    """x @ a (mod p) — the reference's row-vector convention (xApy)."""
    return modmatmul(f, x[None, :], a)[0]
