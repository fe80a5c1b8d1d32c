"""Multi-chip distributed elimination over a jax.sharding Mesh.

The reference is a single-node OpenMP library (SURVEY.md section 2.11); this
module is its scale-out replacement, designed for ICI collectives:

* matrix rows are sharded over mesh axis ``"rows"`` (the domain's
  data-parallel axis);
* **pivot election** = two ``pmin`` all-reduces (weight, then row-id
  tie-break) — deterministic, independent of shard count;
* **pivot-row exchange** = one ``psum`` (each shard contributes its winning
  rows, zeros elsewhere) — the all-gather of U panels over ICI;
* the C elected FL pivots form a unit upper-triangular panel T = U[:, cols];
  we Jordan-normalize with an exact log-depth Neumann inverse
  (T^{-1} = prod (I + (-N)^{2^i}), N = T - I nilpotent) so the Schur update
  is ONE exact int8-limb matmul per shard per round:
      X <- X - X[:, cols] @ (T^{-1} U).

Everything is static-shaped: pivot counts live in masks, the panel width C
is fixed, empty pivot slots are padded with identity columns that multiply
by zero.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..field import Field
from ..ops import modmul
from ..ops.matmul import modmatmul

BIG = jnp.int32(2**31 - 1)


def make_mesh(n_devices=None, axis="rows"):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _neumann_inverse(f: Field, T):
    """Exact inverse of a unit upper-triangular (C, C) panel over GF(p):
    (I + N)^{-1} = prod_i (I + (-N)^(2^i)), N strictly upper nilpotent."""
    C = T.shape[0]
    eye = (jax.lax.broadcasted_iota(jnp.int32, (C, C), 0)
           == jax.lax.broadcasted_iota(jnp.int32, (C, C), 1)).astype(jnp.int32)
    M = modmul.sub(f, eye, T)  # M = -N
    acc = modmul.add(f, eye, M)
    steps = max(1, (C - 1).bit_length())
    for _ in range(steps - 1):
        M = modmatmul(f, M, M)
        acc = modmatmul(f, modmul.add(f, eye, M), acc)
    return acc


def _local_fl_candidates(f: Field, X, row_offset):
    """Per-column best (weight, global row) among local rows whose leftmost
    nonzero is that column.  Empty columns get (BIG, BIG)."""
    nloc, m = X.shape
    nz = X != 0
    has = nz.any(axis=1)
    weight = nz.sum(axis=1).astype(jnp.int32)
    left = jnp.argmax(nz, axis=1).astype(jnp.int32)
    left = jnp.where(has, left, m)  # park empty rows off-end
    gid = row_offset + jax.lax.broadcasted_iota(jnp.int32, (nloc, 1), 0)[:, 0]
    bw = jnp.full((m + 1,), BIG, jnp.int32).at[left].min(
        jnp.where(has, weight, BIG))
    # row-id tie-break among local rows achieving the per-column best weight
    is_best = (weight == bw[left]) & has
    br = jnp.full((m + 1,), BIG, jnp.int32).at[left].min(
        jnp.where(is_best, gid, BIG))
    return bw[:m], br[:m]


def _elimination_round_local(f: Field, C: int, axis: str, X, row_offset):
    """One distributed FL elimination round (runs inside shard_map).

    Returns (X', U, piv_cols, piv_valid, my_piv_mask): X' with pivot
    columns eliminated and pivot rows zeroed; U the (C, m) Jordan-reduced
    pivot panel (replicated)."""
    nloc, m = X.shape
    bw, br = _local_fl_candidates(f, X, row_offset)
    bw_g = jax.lax.pmin(bw, axis)                     # best weight per col
    cand = jnp.where(bw == bw_g, br, BIG)
    br_g = jax.lax.pmin(cand, axis)                   # winner row per col
    has_piv = bw_g < BIG

    # choose the first C pivot columns (ascending) — static-size panel
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    ranked = jnp.where(has_piv, col_ids, m)
    cols = jax.lax.sort(ranked)[:C]                   # padded with m
    valid = cols < m
    cols_safe = jnp.where(valid, cols, 0)

    # each shard contributes the rows it won.  The exchange is OVERLAPPED
    # with the Schur compute: first a small (C, C) psum of just the pivot
    # columns (enough to build the panel inverse), then the full panel in
    # column stripes — each stripe's all-reduce is independent of the
    # previous stripe's matmul update, so XLA's async collectives hide
    # the exchange behind the matmuls (the device-link analog of the
    # reference's
    # OpenMP overlap, src/SpaSM.jl:470-475).
    win_row = br_g[cols_safe]                         # global row id per slot
    local_idx = win_row - row_offset
    mine = valid & (local_idx >= 0) & (local_idx < nloc)
    idx_safe = jnp.clip(local_idx, 0, nloc - 1)
    contrib = jnp.where(mine[:, None], X[idx_safe], 0)

    T_raw = jax.lax.psum(contrib[:, cols_safe], axis)  # (C, C) — small
    pivval = T_raw[jnp.arange(C), jnp.arange(C)]  # row k's own pivot column
    pinv = _inv_vector(f, pivval)
    pinv = jnp.where(valid, pinv, 1)
    T = modmul.mul(f, T_raw, pinv[:, None])
    eye = (jax.lax.broadcasted_iota(jnp.int32, (C, C), 0)
           == jax.lax.broadcasted_iota(jnp.int32, (C, C), 1)).astype(jnp.int32)
    T = jnp.where((~valid)[:, None] | (~valid)[None, :], eye, T)
    Tinv = _neumann_inverse(f, T)
    # fold the unit-pivot scaling into the normalizer: S = Tinv @ diag(pinv)
    S_norm = modmul.mul(f, Tinv, pinv[None, :])

    coeff = X[:, cols_safe]
    coeff = jnp.where(valid[None, :], coeff, 0)
    n_stripes = min(4, max(1, m // 512))
    bounds = [m * s // n_stripes for s in range(n_stripes + 1)]
    U_parts = []
    X_parts = []
    prev_Us = None
    for s in range(n_stripes):
        s0, s1 = bounds[s], bounds[s + 1]
        sl = contrib[:, s0:s1]
        if prev_Us is not None:
            # Software pipeline: chain this stripe's exchange on the
            # PREVIOUS exchanged stripe (not on its matmuls) via an
            # optimization barrier.  Without it XLA's all-reduce combiner
            # merges every stripe psum into ONE tuple all-reduce (seen in
            # the optimized HLO at these sizes), i.e. a single blocking
            # exchange; with the chain, stripe s+1's all-reduce runs
            # concurrently with stripe s's matmul updates (which the psum
            # does not depend on) — the intended exchange/compute overlap.
            sl, _ = jax.lax.optimization_barrier((sl, prev_Us))
        Us = jax.lax.psum(sl, axis)                   # stripe exchange
        prev_Us = Us
        Ur = modmatmul(f, S_norm, Us)                 # normalized stripe
        U_parts.append(Ur)
        X_parts.append(modmul.sub(f, X[:, s0:s1], modmatmul(f, coeff, Ur)))
    U = jnp.concatenate(U_parts, axis=1)
    X = jnp.concatenate(X_parts, axis=1)
    # remove pivot rows from the active matrix
    gid = row_offset + jax.lax.broadcasted_iota(jnp.int32, (nloc, 1), 0)[:, 0]
    is_piv_row = (gid[:, None] == jnp.where(valid, win_row, -1)[None, :]).any(1)
    X = jnp.where(is_piv_row[:, None], 0, X)
    npiv = valid.sum().astype(jnp.int32)
    return X, U, cols, valid, npiv


def _inv_vector(f: Field, x):
    """Vectorized Fermat inverse (0 -> 0)."""
    e = f.p - 2
    result = jnp.ones_like(x)
    base = x
    while e:
        if e & 1:
            result = modmul.mul(f, result, base)
        base = modmul.mul(f, base, base)
        e >>= 1
    return result


def elimination_round(f: Field, mesh: Mesh, X_sharded, panel: int = 128,
                      axis: str = "rows"):
    """Jitted distributed round: X (n, m) int32 sharded over rows.  Returns
    (X', U, piv_cols, valid, npiv)."""
    n, m = X_sharded.shape
    panel = min(panel, m)
    nshards = mesh.shape[axis]
    assert n % nshards == 0, "pad rows to a multiple of the mesh size"
    nloc = n // nshards

    def body(X_l):
        shard = jax.lax.axis_index(axis).astype(jnp.int32)
        return _elimination_round_local(f, panel, axis, X_l,
                                        shard * nloc)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=P(axis, None),
        out_specs=(P(axis, None), P(), P(), P(), P()))
    return fn(X_sharded)


@functools.partial(jax.jit, static_argnums=(0, 1, 3), donate_argnums=2)
def _round_jit(f: Field, mesh, X, panel):
    return elimination_round(f, mesh, X, panel)


def distributed_rank(f: Field, mesh: Mesh, X, panel: int = 128,
                     max_rounds: int | None = None) -> int:
    """Rank of a dense matrix by repeated distributed FL elimination
    rounds.  X: (n, m) int32 (host or device); rows padded to the mesh."""
    X = np.asarray(X)
    n, m = X.shape
    nshards = mesh.shape["rows"]
    pad = (-n) % nshards
    if pad:
        X = np.vstack([X, np.zeros((pad, m), X.dtype)])
    sharding = NamedSharding(mesh, P("rows", None))
    Xd = jax.device_put(jnp.asarray(X, jnp.int32), sharding)
    rank = 0
    rounds = 0
    limit = max_rounds if max_rounds is not None else m + 1
    while rounds < limit:
        Xd, U, cols, valid, npiv = _round_jit(f, mesh, Xd, panel)
        k = int(npiv)
        rank += k
        rounds += 1
        if k == 0:
            break
    return rank
