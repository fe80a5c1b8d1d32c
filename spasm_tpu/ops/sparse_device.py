"""Device-resident sparse wave elimination over GF(p).

The host path (elimination.py) runs the level-wave Schur updates through
scipy SpGEMM.  This module is the device-resident equivalent for matrices too
large / too hot for host round trips: the working matrix lives on device as
fixed-capacity COO, pivot rows as a padded ELL block, and one wave is an
expand -> multi-key sort -> segment-reduce -> compact pipeline:

  1. entries sitting in a wave-t pivot column are the coefficients;
  2. each coefficient emits that pivot row's ELL entries scaled by -coef
     (the emitted entry at the pivot column cancels the coefficient entry
     exactly — unit pivots — so no deletion step is needed);
  3. old + emitted entries are sorted by (row, col) (lax.sort, two int32
     keys) and duplicate positions are summed exactly (values stay in the
     balanced range, chunk-safe int32 adds via segment ids);
  4. the result is compacted back into the fixed capacity.

All shapes are static; capacity overflow is detected and reported so the
caller can fall back to the host path (no silent truncation).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..field import Field
from . import modmul


def _segments_sum_mod(f: Field, vals, seg_change):
    """Sum runs of equal (row, col) positions exactly (mod p, balanced).

    Hand-rolled segmented Hillis-Steele scan: log2(n) passes of a
    static-slice shift + flag-masked balanced add.  Each add keeps values
    in [-p/2, p/2] via conditional +-p folds (division-free; exact for
    every tier incl. 'c').  Replaces a lax.associative_scan with a custom
    tuple monoid, whose lowering stalled at 2^25-element pools on the
    first (non-GPU) accelerator (git history).  v[i] = prefix sum of i's segment up to i; the LAST
    element of each run holds the full segment sum."""
    n = vals.shape[0]
    half = jnp.int32(f.halfp)
    mhalf = jnp.int32(f.mhalfp)

    def fold_add(a, b):
        # |a + b| <= p: one conditional fold each side lands balanced.
        # tier-c: p/2 < 2**31 so a + b is exact in int32 except p odd...
        # |a+b| <= p <= 2**32-5 does NOT fit int32 for tier-c; route
        # through modmul.add there (uint32 wrap-aware).
        s = a + b
        s = jnp.where(s > half, s - jnp.int32(f.p), s)
        return jnp.where(s < mhalf, s + jnp.int32(f.p), s)

    add = fold_add if f.p <= (1 << 30) else (
        lambda a, b: modmul.add(f, a, b))
    v = vals
    flg = seg_change
    shift = 1
    while shift < n:
        v_prev = jnp.concatenate([jnp.zeros(shift, v.dtype), v[:-shift]])
        f_prev = jnp.concatenate([jnp.ones(shift, bool), flg[:-shift]])
        v = jnp.where(flg, v, add(v, v_prev))
        flg = flg | f_prev
        shift <<= 1
    return v


def make_wave_body(f: Field, cap: int, cap_hits: int,
                   u_cols, u_vals, level_of, col2piv, sentinel):
    """Build the one-wave closure shared by the standalone eliminator and
    the device-resident round loop (ops/resident.py).  u_cols/u_vals:
    (npiv_cap, Ku) ELL; level_of (npiv_cap,); col2piv (m,); entries at
    rows == sentinel are dead."""
    npiv_cap, Ku = u_cols.shape
    m = col2piv.shape[0]

    def one_wave(t, carry):
        rows, cols, vals, overflow = carry
        piv = jnp.where(cols >= 0, col2piv[jnp.clip(cols, 0, m - 1)], -1)
        is_hit = (piv >= 0) & (vals != 0) & (rows < sentinel)
        is_hit &= jnp.where(piv >= 0,
                            level_of[jnp.clip(piv, 0, npiv_cap - 1)] == t,
                            False)
        nhits = is_hit.sum()
        overflow = overflow | (nhits > cap_hits)
        hit_idx = jnp.nonzero(is_hit, size=cap_hits, fill_value=cap)[0]
        hit_ok = hit_idx < cap
        hi = jnp.clip(hit_idx, 0, cap - 1)
        h_row = jnp.where(hit_ok, rows[hi], sentinel)
        h_piv = jnp.where(hit_ok, piv[hi], 0)
        h_coef = jnp.where(hit_ok, vals[hi], 0)
        # expansion: (cap_hits, Ku)
        e_cols = u_cols[h_piv]                      # (cap_hits, Ku)
        e_vals = modmul.mul(f, modmul.neg(f, h_coef)[:, None],
                            u_vals[h_piv])
        e_rows = jnp.broadcast_to(h_row[:, None], e_cols.shape)
        e_live = (e_cols >= 0) & (e_vals != 0) & (e_rows < sentinel)
        e_rows = jnp.where(e_live, e_rows, sentinel).reshape(-1)
        e_cols = jnp.where(e_live, e_cols, 0).reshape(-1)
        e_vals = jnp.where(e_live, e_vals, 0).reshape(-1)
        # merge + sort by (row, col)
        a_rows = jnp.concatenate([rows, e_rows])
        a_cols = jnp.concatenate([cols, e_cols])
        a_vals = jnp.concatenate([vals, e_vals])
        a_rows, a_cols, a_vals = jax.lax.sort(
            (a_rows, a_cols, a_vals), num_keys=2)
        # segment-reduce duplicates
        change = jnp.ones(a_rows.shape, bool)
        change = change.at[1:].set(
            (a_rows[1:] != a_rows[:-1]) | (a_cols[1:] != a_cols[:-1]))
        sums = _segments_sum_mod(f, a_vals, change)
        is_last = jnp.ones(a_rows.shape, bool)
        is_last = is_last.at[:-1].set(change[1:])
        keep = is_last & (sums != 0) & (a_rows < sentinel)
        nkeep = keep.sum()
        overflow = overflow | (nkeep > cap)
        kidx = jnp.nonzero(keep, size=cap, fill_value=a_rows.shape[0])[0]
        kok = kidx < a_rows.shape[0]
        ki = jnp.clip(kidx, 0, a_rows.shape[0] - 1)
        rows = jnp.where(kok, a_rows[ki], sentinel)
        cols = jnp.where(kok, a_cols[ki], 0)
        vals = jnp.where(kok, sums[ki], 0)
        return rows, cols, vals, overflow

    return one_wave


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def wave_eliminate_device(f: Field, cap: int, cap_hits: int, depth: int,
                          s_rows, s_cols, s_vals,
                          u_cols, u_vals, piv_col_of, level_of, col2piv,
                          nrows):
    """Eliminate every pivot column from the device COO matrix S.

    S: (cap,) rows/cols/vals, padding rows == nrows (sentinel), vals 0.
    U: (npiv, Ku) ELL cols (padding -1) / vals (padding 0), unit pivots.
    piv_col_of (npiv,), level_of (npiv,), col2piv (m,) with -1 for
    non-pivot columns.  depth = number of waves (static).

    Returns (rows, cols, vals, nnz, overflow).
    """
    sentinel = jnp.int32(nrows)
    one_wave = make_wave_body(f, cap, cap_hits, u_cols, u_vals, level_of,
                              col2piv, sentinel)
    # derive the initial overflow flag from the inputs so its sharding
    # axes match the loop body's output under shard_map
    overflow0 = jnp.any(s_rows < -1)  # always False, input-derived
    rows, cols, vals, overflow = jax.lax.fori_loop(
        0, depth, one_wave, (s_rows, s_cols, s_vals, overflow0))
    nnz = (rows < sentinel).sum()
    return rows, cols, vals, nnz, overflow


def ell_pack(U):
    """Pack a SparseGFp's rows into a padded ELL block (cols padded -1,
    vals padded 0) — vectorized (no per-row Python loop)."""
    npiv = U.shape[0]
    Ku = int(U.row_lengths().max()) if U.nnz else 1
    u_cols = np.full((npiv, Ku), -1, np.int64)
    u_vals = np.zeros((npiv, Ku), np.int64)
    if U.nnz:
        re = U.rows_expanded()
        pos = np.arange(U.nnz, dtype=np.int64) - U.indptr[re]
        u_cols[re, pos] = U.indices
        u_vals[re, pos] = U.data
    return u_cols, u_vals


def eliminate_device(f: Field, U, piv_cols, levels, B, cap_factor=4,
                     cap_hits=None):
    """Host-facing wrapper: U, B SparseGFp; returns the eliminated B or
    None on capacity overflow (caller falls back to the host waves).

    Round 5 status: this wave design is the FALLBACK behind the one-pass
    batched merge (ops/sparse_onepass.py) — it eliminates against the
    UNREDUCED pivot block level by level, so it handles the dense-U*
    regime the one-pass work-budget gate rejects.  Single-chip
    economics on the first (non-GPU) accelerator (tools/
    device_crossover.py, git history): waves lost to the OpenMP host
    kernel by 2-3 orders of magnitude and to the one-pass merge by ~7-9x
    (not measured on H100); keep
    `device_sparse_min_nnz` at its 0 (disabled) default on one chip.
    The supported device use is the MESH path (one-pass tiles sharded
    over the mesh, this module's waves as overflow/dense-U* fallback)."""
    npiv, m = U.shape
    q = B.shape[0]
    u_cols, u_vals = ell_pack(U)
    col2piv = np.full(m, -1, np.int64)
    col2piv[np.asarray(piv_cols)] = np.arange(npiv)
    i, j, v = B.to_coo()
    cap = max(1024, 1 << int(cap_factor * max(1, B.nnz) - 1).bit_length())
    if cap_hits is None:
        cap_hits = max(256, cap // 8)
    s_rows = np.full(cap, q, np.int64)
    s_cols = np.zeros(cap, np.int64)
    s_vals = np.zeros(cap, np.int64)
    s_rows[:i.size] = i
    s_cols[:j.size] = j
    s_vals[:v.size] = v
    depth = int(np.asarray(levels).max()) + 1 if npiv else 0
    if depth == 0:
        return B
    rows, cols, vals, nnz, overflow = wave_eliminate_device(
        f, cap, cap_hits, depth,
        jnp.asarray(s_rows, jnp.int32), jnp.asarray(s_cols, jnp.int32),
        jnp.asarray(s_vals, jnp.int32),
        jnp.asarray(u_cols, jnp.int32), jnp.asarray(u_vals, jnp.int32),
        jnp.asarray(np.asarray(piv_cols), jnp.int32),
        jnp.asarray(np.asarray(levels), jnp.int32),
        jnp.asarray(col2piv, jnp.int32), q)
    if bool(overflow):
        return None
    rows = np.asarray(rows)
    keep = rows < q
    from ..csr import SparseGFp

    return SparseGFp.from_coo(f, q, m, rows[keep],
                              np.asarray(cols)[keep],
                              np.asarray(vals)[keep],
                              sum_duplicates=False)
