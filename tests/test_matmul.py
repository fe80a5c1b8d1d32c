"""The jnp modular matmul (ops/matmul.py) against the Python big-int
oracle: every limb count, unaligned shapes, and a contraction longer than
one exact int32 chunk (_k_chunk)."""

import numpy as np
import pytest

from spasm_tpu.field import field, num_limbs


@pytest.mark.parametrize("p", [5, 257, 1031, 42013, 92681, 104729,
                               2**31 - 19, 2**32 - 5])
def test_modmatmul_jnp_exact(p, rng):
    import jax.numpy as jnp

    from spasm_tpu.ops.matmul import _k_chunk, modmatmul

    f = field(p)
    k = _k_chunk(num_limbs(p)) + 37  # two chunks, the second ragged
    a = f.rand((3, k), rng)
    b = f.rand((k, 5), rng)
    a[0, :] = f.halfp  # extremes of the balanced range
    b[:, 0] = f.mhalfp
    got = np.asarray(modmatmul(f, jnp.asarray(a, jnp.int32),
                               jnp.asarray(b, jnp.int32)))
    want = f.normalize(a.astype(object) @ b.astype(object))
    np.testing.assert_array_equal(got, want.astype(np.int64))
