#!/usr/bin/env python
"""Micro-benchmarks for the dense-finish pieces on the live backend."""
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

import spasm_tpu as st
from spasm_tpu.ops import dense as dense_ops
from spasm_tpu.ops.matmul import modmatmul

f = st.field(42013)
rng = np.random.default_rng(0)


def timeit(name, fn, reps=3):
    jax.block_until_ready(fn())  # warm/compile
    t0 = time.time()
    for _ in range(reps):
        r = fn()
    jax.block_until_ready(r)
    dt = (time.time() - t0) / reps
    print(f"{name}: {dt*1e3:.1f} ms")
    return dt


# 1. XLA panel loop alone: (1024, 128)
P = jnp.asarray(rng.integers(-21000, 21000, (1024, 128)), jnp.int32)
ispiv = jnp.zeros(1024, bool)
panel = jax.jit(lambda P, ip: dense_ops._panel_eliminate(f, P, ip, 0, 10000))
timeit("_panel_eliminate 1024x128", lambda: panel(P, ispiv))

# 2. modmatmul (1024, 11264) @ (11264, 10240)
A = jnp.asarray(rng.integers(-21000, 21000, (1024, 11264)), jnp.int32)
B = jnp.asarray(rng.integers(-21000, 21000, (11264, 10240)), jnp.int32)
timeit("modmatmul 1024x11264x10240", lambda: modmatmul(f, A, B))

# 3. modmatmul G-shaped (1024,128)@(128,10240)
G = jnp.asarray(rng.integers(-21000, 21000, (1024, 128)), jnp.int32)
PB = jnp.asarray(rng.integers(-21000, 21000, (128, 10240)), jnp.int32)
timeit("modmatmul 1024x128x10240", lambda: modmatmul(f, G, PB))

# 4. full _rref_jit on (1024, 10240)
X = jnp.asarray(rng.integers(-21000, 21000, (1024, 10240)), jnp.int32)
timeit("_rref_jit 1024x10240",
       lambda: dense_ops._rref_jit(f, X, 10240, 128, False), reps=1)

# 5. one blocked_finish_step (1024 block, na=10240, cap=11264)
cap = 11264
rows = jnp.asarray(rng.integers(0, 1024, 4096), jnp.int32)
cols = jnp.asarray(rng.integers(0, 10240, 4096), jnp.int32)
vals = jnp.asarray(rng.integers(-21000, 21000, 4096), jnp.int32)


def step():
    Ud = jnp.zeros((cap, 10240), jnp.int32)
    pc = jnp.zeros((cap,), jnp.int32)
    out = dense_ops.blocked_finish_step(f, (1024, 10240), 128, rows, cols,
                                        vals, Ud, pc, jnp.int32(0))
    return out[0]


timeit("blocked_finish_step 1024x10240", step, reps=1)

# 6. rref 4096x4096 end to end
X2 = np.asarray(rng.integers(-21000, 21000, (4096, 4096)), np.int64)
t0 = time.time()
out = dense_ops.rref(f, X2)
print(f"rref 4096x4096 (cold): {time.time()-t0:.2f} s rank={out['rank']}")
t0 = time.time()
out = dense_ops.rref(f, X2)
print(f"rref 4096x4096 (warm): {time.time()-t0:.2f} s")
