"""One-pass qinv Schur update on device — the device SPA analog.

The host production path (csrc/schur_mod.c — the analog of the reference's
scatter loop, src/SpaSM.jl:619-621,758-770) eliminates every pivot column
from a row block B in ONE pass against a mutually reduced pivot block U*:
each coefficient is read directly off B (C[i,k] = B[i, pivcol(k)]) and the
row update is a sparse accumulator scatter.

This module is the device formulation of that same one-pass contract,
written without random scatter: the SPA becomes a **batched per-row
merge** (XLA's sort on every backend):

  1. rows of B with no pivot hits pass through untouched (host keeps them);
  2. hit rows are bucketed into (pow2 |row|, pow2 #hits, pow2 max |U row|)
     width classes so every device call has static shapes;
  3. per class, one jitted call: gather the referenced U* rows (compacted
     per-class ELL), scale by -coeff (exact mod-p, ops/modmul tiers a/b/c),
     lay row + expansions side by side in a (R, W) tile, ONE batched
     per-row `lax.sort` by column, then a log-shift segmented modular sum
     merges duplicates (the B hit entry cancels the unit pivot exactly);
  4. the surviving (col, val) slots come back with a keep mask; the host
     compacts and splices them with the untouched rows.

Versus the retired wave design (git history: ops/resident.py, and
sparse_device.py's depth-deep loop), this does ONE width-W per-row sort
instead of `depth` full-pool sorts: total sort work R*W*log^2(W) with
W ~ 2^8 instead of N*log^2(N) with N ~ 2^25, and every stage is
embarrassingly row-parallel (shard_map splits R).

Crossover economics are measured by tools/device_crossover.py (not yet
measured on H100); `echelonize(device_sparse_min_nnz=...)` opts in.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..field import Field
from . import modmul


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _ceil_pow4(x) -> "np.ndarray":
    """Vectorized: smallest power of 4 >= x (>=1).  Coarser class keys
    keep the number of distinct compiled tile shapes small — each compile
    costs seconds (kept from the first, non-GPU tuning; compile cost not
    measured on H100)."""
    x = np.maximum(np.asarray(x, np.int64), 1)
    nb = np.int64(np.ceil(np.log2(x)))
    return np.int64(1) << ((nb + 1) // 2 * 2)


def _addmod(f: Field):
    """Balanced exact add closure (same folds as sparse_device)."""
    if f.p <= (1 << 30):
        half = jnp.int32(f.halfp)
        mhalf = jnp.int32(f.mhalfp)
        p = jnp.int32(f.p)

        def fold_add(a, b):
            s = a + b
            s = jnp.where(s > half, s - p, s)
            return jnp.where(s < mhalf, s + p, s)

        return fold_add
    return lambda a, b: modmul.add(f, a, b)


@functools.partial(jax.jit, static_argnums=(0, 8))
def _onepass_class(f: Field, b_cols, b_vals, hit_k, hit_c, hit_ok,
                   u_cols, u_vals, m):
    """One width class: (R, Wb) B rows + (R, H) hits against (nref, Ku)
    compacted U* ELL.  Returns (cols, vals, keep) of shape (R, Wt) with
    Wt = Wb + H*Ku; dead slots have col == m.

    All index inputs are int32; values are balanced int32.
    """
    R, Wb = b_cols.shape
    H = hit_k.shape[1]
    Ku = u_cols.shape[1]
    msent = jnp.int32(m)
    # expansion: -coeff * U*[k] per hit, dead hits masked to the sentinel
    e_cols = jnp.where(hit_ok[:, :, None], u_cols[hit_k], msent)
    e_vals = modmul.mul(f, modmul.neg(f, hit_c)[:, :, None], u_vals[hit_k])
    e_vals = jnp.where(hit_ok[:, :, None], e_vals, 0)
    tile_cols = jnp.concatenate([b_cols, e_cols.reshape(R, H * Ku)], axis=1)
    tile_vals = jnp.concatenate([b_vals, e_vals.reshape(R, H * Ku)], axis=1)
    # one batched per-row sort by column (dead slots sort last: col == m)
    tile_cols, tile_vals = jax.lax.sort((tile_cols, tile_vals), num_keys=1)
    # segmented inclusive modular sum over runs of equal columns
    Wt = tile_cols.shape[1]
    add = _addmod(f)
    change = jnp.concatenate(
        [jnp.ones((R, 1), bool), tile_cols[:, 1:] != tile_cols[:, :-1]],
        axis=1)
    v = tile_vals
    flg = change
    shift = 1
    while shift < Wt:
        v_prev = jnp.pad(v[:, :-shift], ((0, 0), (shift, 0)))
        f_prev = jnp.pad(flg[:, :-shift], ((0, 0), (shift, 0)),
                         constant_values=True)
        v = jnp.where(flg, v, add(v, v_prev))
        flg = flg | f_prev
        shift <<= 1
    last = jnp.concatenate(
        [tile_cols[:, 1:] != tile_cols[:, :-1], jnp.ones((R, 1), bool)],
        axis=1)
    keep = last & (v != 0) & (tile_cols < msent)
    return tile_cols, v, keep, keep.sum()


@functools.partial(jax.jit, static_argnums=(3,))
def _compact_class(tile_cols, tile_vals, keep, size):
    """Gather the kept slots into flat (rowid, col, val) arrays of static
    length `size` (== keep.sum(), fetched by the host between the two
    calls) so only real nonzeros cross the link."""
    R, Wt = tile_cols.shape
    flat = jnp.nonzero(keep.reshape(-1), size=size, fill_value=R * Wt)[0]
    flat = jnp.minimum(flat, R * Wt - 1).astype(jnp.int32)
    rows = flat // jnp.int32(Wt)
    return rows, tile_cols.reshape(-1)[flat], tile_vals.reshape(-1)[flat]


@functools.lru_cache(maxsize=64)
def _compact_sharded_fn(mesh, axis, Rl, Wt, size_pad):
    from jax.sharding import PartitionSpec as P

    def body(tc, tv, kp):
        kflat = kp.reshape(-1)
        flat = jnp.nonzero(kflat, size=size_pad, fill_value=Rl * Wt)[0]
        cnt = kflat.sum()
        safe = jnp.minimum(flat, Rl * Wt - 1).astype(jnp.int32)
        rows = (safe // jnp.int32(Wt)
                + jax.lax.axis_index(axis).astype(jnp.int32)
                * jnp.int32(Rl))
        return (rows[None], tc.reshape(-1)[safe][None],
                tv.reshape(-1)[safe][None],
                cnt.astype(jnp.int32)[None])

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis))))


def _compact_class_sharded(mesh, axis, tile_cols, tile_vals, keep,
                           size_pad):
    """Per-shard compaction under a mesh: a GLOBAL size-bounded
    jnp.nonzero over a row-sharded tile makes GSPMD serialize the whole
    cumsum through collectives (measured: stuck for minutes at 33M slots
    on the CPU mesh) — so each shard compacts its local block to the
    shared static capacity and the host splices via per-shard counts."""
    R, Wt = tile_cols.shape
    nsh = int(mesh.shape[axis])
    Rl = R // nsh
    from ..parallel.sparse_sharded import _global_get

    fn = _compact_sharded_fn(mesh, axis, Rl, Wt, size_pad)
    rows, ck, cv, cnts = fn(tile_cols, tile_vals, keep)
    rows = _global_get(rows).reshape(nsh, size_pad)
    ck = _global_get(ck).reshape(nsh, size_pad)
    cv = _global_get(cv).reshape(nsh, size_pad)
    cnts = _global_get(cnts).reshape(-1)
    sel = np.arange(size_pad)[None, :] < cnts[:, None]
    return rows[sel], ck[sel], cv[sel]


# row-count padding floor: keeps the number of distinct compiled shapes low
_R_PAD = 128


def eliminate_onepass_device(f: Field, Ustar, piv_cols, B,
                             max_tile_slots: int = 1 << 27,
                             work_budget: int = 1 << 30,
                             min_class_rows: int = 2048,
                             mesh=None, mesh_axis: str = "rows",
                             _stats: dict | None = None):
    """Device one-pass Schur: D = B - B[:, piv_cols] @ U* (mod p).

    Ustar: scipy CSR, MUTUALLY REDUCED (unit pivots, no entries in other
    pivot columns — elimination.mutual_reduce).  B: scipy CSR.  Returns a
    canonical scipy CSR equal to the host eliminate_against_reduced.
    Classes wider than ``max_tile_slots`` padded slots stream through
    fixed-height row chunks.  Returns None (caller falls back) when the
    TOTAL padded slot count across all chunks exceeds ``work_budget`` —
    mutual reduction can densify U* (e.g. mid-echelonize boundary
    rounds), and a pow4-padded Ku then multiplies every hit row's merge
    width by the dense U* row length; the level-wave fallback handles
    that regime with the sparse unreduced block instead.

    With ``mesh``, each class tile is row-sharded over the mesh
    (NamedSharding on ``mesh_axis``; U* tiles replicated — the pivot-row
    all-gather role): every merge stage is row-parallel, so the jitted
    class call partitions with no collectives until the final compaction.
    This is the multi-chip sparse-Schur path of SURVEY section 2.11
    item 1.
    """
    Ustar = sp.csr_matrix(Ustar)
    B = sp.csr_matrix(B)
    q, m = B.shape
    r = Ustar.shape[0]
    if r == 0 or B.nnz == 0:
        return B.copy()
    piv_cols = np.asarray(piv_cols, np.int64)
    qinv = np.full(m, -1, np.int64)
    qinv[piv_cols] = np.arange(r)

    b_indptr = np.asarray(B.indptr, np.int64)
    b_idx = np.asarray(B.indices, np.int64)
    b_val = np.asarray(B.data, np.int64)
    k_of = qinv[b_idx]                       # (nnz,) U row per entry or -1
    hit = k_of >= 0
    lens = np.diff(b_indptr)
    # per-row hit counts + per-row max referenced-U-row length
    csum = np.concatenate([[0], np.cumsum(hit)])
    nh = csum[b_indptr[1:]] - csum[b_indptr[:-1]]
    hot = np.flatnonzero(nh > 0)
    if hot.size == 0:
        return B.copy()
    ulen = np.diff(np.asarray(Ustar.indptr, np.int64))
    uh = np.where(hit, ulen[np.clip(k_of, 0, None)], 0)
    kmax = np.zeros(q, np.int64)
    nz_rows = np.flatnonzero(lens > 0)
    if nz_rows.size:
        kmax[nz_rows] = np.maximum.reduceat(uh, b_indptr[nz_rows])
    # class key per hot row: pow4 quantization keeps compiled-shape count
    # low (compiles are expensive); tiny classes go to the host kernel
    keys = np.stack([_ceil_pow4(lens[hot]), _ceil_pow4(nh[hot]),
                     _ceil_pow4(kmax[hot])], 1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    groups = []
    host_rows: list[np.ndarray] = []
    for g in range(uniq.shape[0]):
        rows_c = hot[np.flatnonzero(inv == g)]
        if rows_c.size < min_class_rows:
            host_rows.append(rows_c)
        else:
            groups.append((tuple(int(x) for x in uniq[g]), rows_c))

    u_indptr = np.asarray(Ustar.indptr, np.int64)
    u_idx = np.asarray(Ustar.indices, np.int64)
    u_val = np.asarray(Ustar.data, np.int64)

    if mesh is not None:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        # multi-process-safe put/get (jax.distributed over DCN): every
        # process holds the identical host-global tiles, the helpers
        # slice/allgather per process (parallel/sparse_sharded)
        from ..parallel.sparse_sharded import _global_put

        shard_rows_nd = NamedSharding(mesh, P(mesh_axis, None))
        rep_nd = NamedSharding(mesh, P())
        nsh = int(mesh.shape[mesh_axis])

        def _put_tile(x):
            return _global_put(np.asarray(x), shard_rows_nd)

        def _put_rep(x):
            return _global_put(np.asarray(x), rep_nd)
    else:
        nsh = 1
        _put_tile = _put_rep = jnp.asarray

    out_cols_parts: list[np.ndarray] = []
    out_vals_parts: list[np.ndarray] = []
    out_rows_parts: list[np.ndarray] = []
    dev_calls = 0
    t_prep = t_dev = t_pull = 0.0
    import time as _time
    chunked = []
    for key, rows_c in groups:
        Wb, H, Ku = key
        Wt = Wb + H * Ku
        # row-chunk classes whose padded tile would exceed max_tile_slots:
        # fixed pow2 chunk heights stream through one compiled shape
        fit = max(max_tile_slots // max(Wt, 1), 1)
        r_cap = max(_R_PAD, 1 << (fit.bit_length() - 1))  # pow2 floor
        if _R_PAD * Wt > max_tile_slots:
            return None  # a single minimal tile cannot fit (pathological)
        for s in range(0, rows_c.size, r_cap):
            chunked.append((key, rows_c[s:s + r_cap]))
    total_slots = sum(
        max(_R_PAD, _ceil_pow2(rc.size), nsh) * (k[0] + k[1] * k[2])
        for k, rc in chunked)
    if total_slots > work_budget:
        return None  # padded merge work blew up (dense U*): fall back
    for (Wb, H, Ku), rows_c in chunked:
        _t0 = _time.perf_counter()
        R = rows_c.size
        R_pad = max(_R_PAD, _ceil_pow2(R))
        R_pad = -(-R_pad // nsh) * nsh  # multiple of the shard count
        L = lens[rows_c]
        total = int(L.sum())
        rowrep = np.repeat(np.arange(R, dtype=np.int64), L)
        base = np.cumsum(L) - L
        pos = np.arange(total, dtype=np.int64) - np.repeat(base, L)
        src = np.repeat(b_indptr[rows_c], L) + pos
        b_cols = np.full((R_pad, Wb), m, np.int32)
        b_vals = np.zeros((R_pad, Wb), np.int32)
        b_cols[rowrep, pos] = b_idx[src]
        b_vals[rowrep, pos] = b_val[src]
        # hits within each class row, packed to the front
        hsel = hit[src]
        ch = np.cumsum(hsel)
        excl = np.repeat(ch[base] - hsel[base], L)
        hpos = (ch - 1 - excl)[hsel]
        hrow = rowrep[hsel]
        ks = k_of[src][hsel]
        # compact the referenced U rows into a per-class ELL; nref is
        # pow2-padded (sentinel rows) so chunks of the same class key
        # reuse one compiled shape instead of recompiling per chunk
        refs, ks_local = np.unique(ks, return_inverse=True)
        nref = refs.size
        uL = ulen[refs]
        utot = int(uL.sum())
        urep = np.repeat(np.arange(nref, dtype=np.int64), uL)
        ubase = np.cumsum(uL) - uL
        upos = np.arange(utot, dtype=np.int64) - np.repeat(ubase, uL)
        usrc = np.repeat(u_indptr[refs], uL) + upos
        nref_pad = max(1, _ceil_pow2(nref))
        u_cols = np.full((nref_pad, Ku), m, np.int32)
        u_vals = np.zeros((nref_pad, Ku), np.int32)
        u_cols[urep, upos] = u_idx[usrc]
        u_vals[urep, upos] = u_val[usrc]
        hit_k = np.zeros((R_pad, H), np.int32)
        hit_c = np.zeros((R_pad, H), np.int32)
        hit_ok = np.zeros((R_pad, H), bool)
        hit_k[hrow, hpos] = ks_local
        hit_c[hrow, hpos] = b_val[src][hsel]
        hit_ok[hrow, hpos] = True
        _t1 = _time.perf_counter()
        t_prep += _t1 - _t0
        cols_d, vals_d, keep_d, cnt_d = _onepass_class(
            f, _put_tile(b_cols), _put_tile(b_vals),
            _put_tile(hit_k), _put_tile(hit_c), _put_tile(hit_ok),
            _put_rep(u_cols), _put_rep(u_vals), m)
        dev_calls += 1
        size = int(cnt_d)  # scalar sync; tiles stay device-resident
        _t2 = _time.perf_counter()
        t_dev += _t2 - _t1
        # pow2-pad the gather size so compiled shapes are reused; the
        # fill entries come last (jnp.nonzero fills after real hits) and
        # the [:size] slice drops them
        size_pad = _ceil_pow2(max(size, 1))
        if mesh is not None:
            rk, ck, cv = _compact_class_sharded(mesh, mesh_axis, cols_d,
                                                vals_d, keep_d, size_pad)
            rk = rk.astype(np.int64)
            ck = ck.astype(np.int64)
            cv = cv.astype(np.int64)
        else:
            rid_d, ck_d, cv_d = _compact_class(cols_d, vals_d, keep_d,
                                               size_pad)
            rk = np.asarray(rid_d, np.int64)[:size]
            ck = np.asarray(ck_d, np.int64)[:size]
            cv = np.asarray(cv_d, np.int64)[:size]
        out_rows_parts.append(rows_c[rk])  # padded rows never kept
        out_cols_parts.append(ck)
        out_vals_parts.append(cv)
        t_pull += _time.perf_counter() - _t2
    # tiny classes: the host one-pass kernel on just those rows (a device
    # call would pay a fresh compile + fixed link latency for a handful
    # of rows)
    nhost = 0
    if host_rows:
        from ..elimination import eliminate_against_reduced

        hrows = np.concatenate(host_rows)
        nhost = hrows.size
        Dh, _ = eliminate_against_reduced(f, Ustar, piv_cols, B,
                                          assume_canonical=True, rows=hrows)
        Dh = sp.csr_matrix(Dh)
        Dh.eliminate_zeros()
        out_rows_parts.append(hrows[Dh.tocoo().row])
        out_cols_parts.append(np.asarray(Dh.indices, np.int64))
        out_vals_parts.append(np.asarray(Dh.data, np.int64))
    if _stats is not None:
        _stats["classes"] = len(groups)
        _stats["chunks"] = len(chunked)
        _stats["device_calls"] = dev_calls
        _stats["host_fallback_rows"] = nhost
        _stats["prep_s"] = round(t_prep, 4)
        _stats["device_s"] = round(t_dev, 4)
        _stats["pull_s"] = round(t_pull, 4)
    # assemble: hot rows from device output, cold rows pass through
    rows_all = np.concatenate(
        out_rows_parts + [np.repeat(np.arange(q), np.where(nh > 0, 0, lens))])
    cold_src = np.flatnonzero(
        ~np.repeat(nh > 0, lens))
    cols_all = np.concatenate(out_cols_parts + [b_idx[cold_src]])
    vals_all = np.concatenate(out_vals_parts + [b_val[cold_src]])
    D = sp.csr_matrix(
        (vals_all, (rows_all, cols_all)), shape=(q, m), dtype=np.int64)
    D.sort_indices()
    return D
