"""Exactness of the device kernels on the GPU: the same big-int and host
oracles as the CPU suite, run on the compiled kernels.

Marked ``chip``; each test skips (through the ``gpu`` fixture) where JAX
finds no GPU.  Run them on a GPU host with

    SPASM_TPU_DEVICE_TESTS=1 python -m pytest tests/test_chip.py -m chip
"""

import numpy as np
import pytest

import spasm_tpu as st
from spasm_tpu.field import Field

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("p", [42013, 92681, 104729, 2**31 - 1,
                               2147483659, 4294967291])
def test_chip_elementwise_tiers(gpu, p, rng):
    import jax.numpy as jnp

    from spasm_tpu.ops import modmul

    f = Field(p)
    a = f.rand(4096, rng).astype(np.int32)
    b = f.rand(4096, rng).astype(np.int32)
    a[:2] = [f.halfp, f.mhalfp]
    b[:2] = [f.halfp, f.mhalfp]
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(np.asarray(modmul.add(f, aj, bj)),
                                  f.add(a, b))
    np.testing.assert_array_equal(np.asarray(modmul.sub(f, aj, bj)),
                                  f.sub(a, b))
    np.testing.assert_array_equal(np.asarray(modmul.mul(f, aj, bj)),
                                  f.mul(a, b))


@pytest.mark.parametrize("p", [5, 42013, 92681, 2**31 - 1, 4294967291])
def test_chip_modmatmul(gpu, p, rng):
    import jax
    import jax.numpy as jnp

    from spasm_tpu.ops.matmul import modmatmul

    f = Field(p)
    a = f.rand((300, 650), rng)  # unaligned on every edge
    b = f.rand((650, 170), rng)
    want = f.normalize(a.astype(object) @ b.astype(object)).astype(np.int64)
    fn = jax.jit(lambda x, y: modmatmul(f, x, y))
    got = np.asarray(fn(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,n,m", [(42013, 1024, 640), (92681, 512, 384),
                                   (104729, 512, 384),
                                   (2147483629, 512, 384),
                                   (4294967291, 512, 384)])
def test_chip_device_rref(gpu, p, n, m, rng):
    from spasm_tpu.ops import dense as dense_ops

    f = Field(p)
    X = f.rand((n, m), rng)
    X[rng.random((n, m)) > 0.25] = 0
    got = dense_ops.rref(f, X, host_cutoff=0)
    want = dense_ops._host_rref(f, X, False)
    assert got["rank"] == want["rank"]
    np.testing.assert_array_equal(got["piv_cols"], want["piv_cols"])
    np.testing.assert_array_equal(got["R"][got["piv_rows"]],
                                  want["R"][want["piv_rows"]])


def test_chip_rank_device_matches_host(gpu):
    A = st.SparseGFp.rand(Field(42013), 3000, 3000, 2e-3,
                          np.random.default_rng(5))
    r_dev = st.rank(A)
    assert r_dev == st.echelonize(A, enable_dense=False).r


def test_chip_boundary_rank(gpu):
    from spasm_tpu.fixtures import expected_boundary_rank, simplex_boundary

    B = simplex_boundary(18, 5)
    assert st.rank(B) == expected_boundary_rank(18, 5)
