"""Dense exact elimination over GF(p) on the accelerator — the FFPACK
replacement.

The reference finishes echelonization with FFLAS-FFPACK dense kernels
(``spasm_ffpack_rref`` / ``spasm_ffpack_LU``, src/SpaSM.jl:802-812).  Here the
same role is played by a blocked Gauss-Jordan elimination built around the
exact int8-limb matrix product (ops/matmul.py):

* the matrix is processed in column panels of width ``c``;
* within a panel, elimination is a masked ``fori_loop`` of rank-1 updates on
  the (n, c) panel only — cheap elementwise work;
* the effect of a panel's row operations on the rest of the matrix is, by
  construction, a **rank-c correction**: every op adds multiples of (at most
  c) pivot rows.  We track it as ``row_i <- row_i + G[i, :] @ rows(piv)``
  with ``G`` (n, c) the accumulated coefficients (pivot-row scalings are
  folded into G — see _panel_eliminate), and apply it to all other columns
  with ONE exact modular matmul (ops/matmul.py) per panel group;
* data-dependent rank / pivot positions live in masks and index vectors, so
  shapes stay static and the whole factorization jits once per shape.

Output is the full RREF (Jordan — eliminated above and below), the rank, the
pivot (row, col) sequence, and optionally the transform rows ``T`` with
``R = T @ A (mod p)`` restricted to pivot rows — enough to reconstruct the
reference's ``LU`` semantics (U = R[pivot rows], qinv from pivot cols, L from
T) for solve/gesv.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..field import Field
from . import modmul
from .matmul import modmatmul

# panel width; kept from the first (non-GPU) tuning, not measured on H100
DEFAULT_PANEL = 128


def _panel_eliminate(f: Field, P, is_piv_row, j0, npivcols: int):
    """Jordan-eliminate the (n, c) panel P whose first column is global
    column j0; only global columns < npivcols are eligible for pivots
    (beyond that lie padding or augmentation columns).

    The pivot-row scaling is folded into the elimination coefficient
    (beta[pr] = pinv - 1; beta[i] = -col[i] * pinv), so one rank-1 update
    per step handles scale + eliminate, and the accumulated correction
    satisfies  row_i_final = X_i + G_i @ X[prows, :]  with no separate row
    scalings: with X the panel before the step and pr the pivot row,
    X' = X + beta (x) X[pr] and G' = G + beta (x) (G[pr] + e_k), so by
    induction P_final = P_0 + G @ P_0[prows] column by column.

    Returns the final panel, the rank-c correction G, per-slot pivot
    rows/cols (c,), the found mask (c,), and the updated is_piv_row mask.
    Slot k of G corresponds to the k-th pivot found in the panel.
    """
    n, c = P.shape

    def body(jj, carry):
        P, G, piv_rows, piv_cols, piv_found, is_piv, kk = carry
        col = jax.lax.dynamic_slice(P, (0, jj), (n, 1))[:, 0]
        eligible = (j0 + jj) < npivcols
        cand = jnp.logical_and(jnp.logical_not(is_piv),
                               jnp.logical_and(col != 0, eligible))
        pr = jnp.argmax(cand).astype(jnp.int32)
        found = cand[pr]
        pinv = modmul.inv_scalar(f, col[pr])
        beta = modmul.mul(f, modmul.neg(f, col), pinv)
        beta = beta.at[pr].set(modmul.sub(f, pinv, jnp.int32(1)))
        beta = jnp.where(found, beta, jnp.int32(0))
        ek = (jax.lax.broadcasted_iota(jnp.int32, (c,), 0) == kk)
        # G[pr, kk] is 0 before this step (slot kk unused), so plain add
        g_row = G[pr] + jnp.where(ek, jnp.int32(1), jnp.int32(0))
        P = modmul.add(f, P, modmul.mul(f, beta[:, None], P[pr][None, :]))
        G = modmul.add(f, G, modmul.mul(f, beta[:, None], g_row[None, :]))
        # bookkeeping
        is_piv = is_piv.at[pr].set(jnp.logical_or(is_piv[pr], found))
        piv_rows = piv_rows.at[kk].set(jnp.where(found, pr, 0))
        piv_cols = piv_cols.at[kk].set(jnp.where(found, jj, 0))
        piv_found = piv_found.at[kk].set(found)
        kk = kk + found.astype(jnp.int32)
        return P, G, piv_rows, piv_cols, piv_found, is_piv, kk

    G0 = jnp.zeros((n, c), jnp.int32)
    piv_rows0 = jnp.zeros((c,), jnp.int32)
    piv_cols0 = jnp.zeros((c,), jnp.int32)
    piv_found0 = jnp.zeros((c,), bool)
    init = (P, G0, piv_rows0, piv_cols0, piv_found0, is_piv_row,
            jnp.int32(0))
    P, G, piv_rows, piv_cols, piv_found, is_piv_row, _ = jax.lax.fori_loop(
        0, c, body, init)
    return P, G, piv_rows, piv_cols, piv_found, is_piv_row


# panels per full-width rank-c correction: the K panels of a group share
# ONE whole-matrix matmul+reduce pass; cross-panel consistency inside a
# group is kept with tiny window corrections (n x c and c x c ops), and
# the corrected pivot rows are resolved once per group by an exact
# Neumann inverse of the strictly-block-lower coefficient matrix.  The
# group size is kept from the first (non-GPU) tuning, not measured on H100
PANEL_GROUP = 4
_FORCE_GROUP = None  # tests override to exercise grouping on CPU


def rref_inplace(f: Field, X, npivcols: int, panel: int = DEFAULT_PANEL):
    """Blocked Jordan RREF of X (n, m) over GF(p).  Only the first
    ``npivcols`` columns are searched for pivots (pass m normally; pass
    fewer when X is augmented, e.g. with an identity to track the
    transform).

    Returns (R, rank, piv_row_of, piv_col_of, is_piv_row) where
    ``piv_row_of[k]`` / ``piv_col_of[k]`` give the k-th pivot in column
    order (padded with -1 past rank) and is_piv_row is the (n,) mask.

    Panels are processed in groups of PANEL_GROUP: within a group, each
    panel sees the previous panels' row operations only on its own column
    window (P += G_l @ R_l[:, window]) and on its pivot rows
    (R_k = X[prows_k] + sum_l G_l[prows_k] @ R_l); the full-width update
    X += [G_1|..|G_K] @ [R_1;..;R_K] happens ONCE per group.  This is
    exact: the row operations of panel k are encoded entirely by
    (G_k, R_k) with R_k the CORRECTED pivot rows, so composing them in
    one concatenated matmul reproduces the sequential Jordan result
    (including the panels' own columns — no write-back needed).
    """
    n, m = X.shape
    nmax = min(n, npivcols)
    npan = -(-npivcols // panel)
    # grouping trades K-1 full-width passes for small extra matmuls: a win
    # on an accelerator, a loss on the CPU backend (tests/emulation) where the
    # small modmatmuls are relatively expensive — group only on device
    # (_FORCE_GROUP lets the CPU tests exercise the grouped path)
    group = _FORCE_GROUP or (PANEL_GROUP
                             if jax.default_backend() != "cpu" else 1)
    ngrp = -(-npan // group)
    m_pad = max(m, ngrp * group * panel)
    if m_pad != m:
        X = jnp.pad(X, ((0, 0), (0, m_pad - m)))

    def do_group(gi, carry):
        # Within a group, panel k's corrected pivot rows satisfy
        #   R_k = X[prows_k] + sum_{l<k} C_kl @ R_l,   C_kl = G_l[prows_k]
        # i.e. Rcat = (I - L)^{-1} Xrows with L strictly block-lower
        # (L^K = 0).  Resolving this ONCE at group end via the exact
        # Neumann product (I + L)(I + L^2)... replaces the per-panel
        # full-width row gathers + (c, m)-wide correction matmuls with a
        # single (Kc, m)-wide matmul; the per-panel window corrections
        # need only (c, c) slices, recovered by the same recurrence at
        # window width.
        X, is_piv, rank, prow_of, pcol_of = carry
        rank_in = rank
        Gs, prows_l, wins = [], [], []
        for k in range(group):
            pi = gi * group + k
            j0 = pi * panel
            Xwin = jax.lax.dynamic_slice(X, (0, j0), (n, panel))
            P = Xwin
            # corrected windows of earlier panels' pivot rows, at THIS
            # panel's columns: R_l|win = Xwin[prows_l] + sum_j C_lj R_j|win
            Rwin = []
            for l in range(k):
                rw = Xwin[prows_l[l], :]
                for j in range(l):
                    rw = modmul.add(
                        f, rw, modmatmul(f, wins[l][j], Rwin[j]))
                Rwin.append(rw)
                P = modmul.add(f, P, modmatmul(f, Gs[l], rw))
            # blocks pre-eliminated against earlier pivots see long runs
            # of all-zero windows before their own columns; the 128-step
            # panel loop costs the same on them, so skip it outright
            P, G, prows, pcols, pfound, is_piv = jax.lax.cond(
                jnp.any(P != 0),
                lambda P, ip: _panel_eliminate(f, P, ip, j0, npivcols),
                lambda P, ip: (P, jnp.zeros((n, panel), jnp.int32),
                               jnp.zeros((panel,), jnp.int32),
                               jnp.zeros((panel,), jnp.int32),
                               jnp.zeros((panel,), bool), ip),
                P, is_piv)
            # C_kl coefficient blocks for the group-end resolve (dummy
            # slots gather arbitrary rows; their Gcat columns are zero)
            wins.append([Gs[l][prows, :] for l in range(k)])
            Gs.append(G)
            prows_l.append(prows)
            # pivot bookkeeping (slot order == column order within panel)
            nfound = pfound.sum().astype(jnp.int32)
            slot = jax.lax.broadcasted_iota(jnp.int32, (panel,), 0)
            slots = jnp.where(pfound, rank + slot, nmax)
            prow_of = prow_of.at[slots].set(jnp.where(pfound, prows, -1),
                                            mode="drop")
            pcol_of = pcol_of.at[slots].set(
                jnp.where(pfound, j0 + pcols, -1), mode="drop")
            rank = rank + nfound
        def apply_group(X):
            Gcat = jnp.concatenate(Gs, axis=1)   # (n, K*c)
            Xrows = X[jnp.concatenate(prows_l), :]       # ONE row gather
            if group > 1:
                Kc = group * panel
                L = jnp.zeros((Kc, Kc), jnp.int32)
                for k in range(group):
                    for l in range(k):
                        L = jax.lax.dynamic_update_slice(
                            L, wins[k][l], (k * panel, l * panel))
                eye = (jax.lax.broadcasted_iota(jnp.int32, (Kc, Kc), 0)
                       == jax.lax.broadcasted_iota(jnp.int32, (Kc, Kc), 1)
                       ).astype(jnp.int32)
                T = modmul.add(f, eye, L)
                Lp = L
                steps = (group - 1).bit_length()
                for _ in range(steps - 1):
                    Lp = modmatmul(f, Lp, Lp)
                    T = modmatmul(f, modmul.add(f, eye, Lp), T)
                Rcat = modmatmul(f, T, Xrows)    # (Kc, m_pad)
            else:
                Rcat = Xrows
            return modmul.add(f, X, modmatmul(f, Gcat, Rcat))

        # no pivots in the whole group => Gcat == 0 => X unchanged
        X = jax.lax.cond(rank > rank_in, apply_group, lambda X: X, X)
        return X, is_piv, rank, prow_of, pcol_of

    is_piv0 = jnp.zeros((n,), bool)
    prow_of0 = jnp.full((nmax,), -1, jnp.int32)
    pcol_of0 = jnp.full((nmax,), -1, jnp.int32)

    # Early exit: once every row that still has nonzeros is a pivot row,
    # later groups are strict no-ops (no candidate rows left).  This is
    # what keeps rank-deficient / tall blocks from scanning all m/128
    # panels at full cost.
    def cond(carry):
        gi, X, is_piv, rank, prow_of, pcol_of, alive = carry
        return jnp.logical_and(gi < ngrp, alive)

    def body(carry):
        gi, X, is_piv, rank, prow_of, pcol_of, _ = carry
        X, is_piv, rank, prow_of, pcol_of = do_group(
            gi, (X, is_piv, rank, prow_of, pcol_of))
        # only pivot-eligible columns count: augmentation columns (e.g. the
        # identity when tracking the transform) never yield pivots
        row_nz = jnp.any(X[:, :npan * panel] != 0, axis=1)
        alive = jnp.logical_and(rank < nmax,
                                jnp.any(jnp.logical_and(row_nz,
                                                        ~is_piv)))
        return gi + 1, X, is_piv, rank, prow_of, pcol_of, alive

    _, X, is_piv, rank, prow_of, pcol_of, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), X, is_piv0, jnp.int32(0), prow_of0,
                     pcol_of0, jnp.bool_(True)))
    return X[:, :m], rank, prow_of, pcol_of, is_piv


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4))
def _rref_jit(f: Field, X, npivcols: int, panel: int, want_transform: bool):
    n, m = X.shape
    if want_transform:
        eye = (jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
               == jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)).astype(jnp.int32)
        Xa = jnp.concatenate([X, eye], axis=1)
    else:
        Xa = X
    R, rank, prow_of, pcol_of, is_piv = rref_inplace(f, Xa, npivcols, panel)
    T = R[:, m:] if want_transform else None
    R = R[:, :m]
    return R, rank, prow_of, pcol_of, is_piv, T


# below this element count, host NumPy elimination beats device compile+run
HOST_CUTOFF = 1 << 20
# ... but for LARGE primes the host int64 matmul must chunk to safe_k
# columns (overflow bound) with a modulo pass per chunk — at p ~ 2^31
# safe_k is 4 and the host path loses ~8x to the limb-plane device path
# already at 800^2 (measured on XLA:CPU; far more on the real chip), so
# the crossover drops to ~256^2
HOST_CUTOFF_BIGP = 1 << 16


def host_cutoff_for(f: Field) -> int:
    """Element-count crossover between the host NumPy elimination and the
    device path, as a function of the prime (see HOST_CUTOFF_BIGP)."""
    half = max(1, f.halfp)
    safe_k = max(1, (1 << 62) // (half * half))
    return HOST_CUTOFF if safe_k >= 256 else HOST_CUTOFF_BIGP


@functools.partial(jax.jit, static_argnums=(0,))
def densify_coo(shape, rows, cols, vals):
    """Scatter COO entries into a dense int32 array on device (saves a
    dense host->device transfer when nnz << n*m)."""
    out = jnp.zeros(shape, jnp.int32)
    return out.at[rows, cols].set(vals)


@functools.partial(jax.jit, static_argnums=(1,))
def extract_sparse(X, cap: int):
    """Device-side sparsity extraction with a static capacity: returns
    (rows, cols, vals) padded to cap (padding rows = -1).  Saves a dense
    device->host transfer when the result is sparse."""
    r, c = jnp.nonzero(X, size=cap, fill_value=-1)
    v = X[jnp.clip(r, 0, X.shape[0] - 1), jnp.clip(c, 0, X.shape[1] - 1)]
    v = jnp.where(r >= 0, v, 0)
    return r, c, v


def count_nonzero_device(X) -> int:
    return int(jnp.count_nonzero(X))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _compact_nonpivot(na: int, ncols_cap: int, Ud, pc_map, r_d):
    """Gather the NON-pivot columns of the accumulated mutual-RREF panel
    Ud[:r_d] into a (cap, ncols_cap) block.  In full mutual RREF every
    pivot column is a unit vector the host already knows (pc_map order),
    so only this block carries information — extracting it instead of the
    whole panel shrinks the device-side nonzero scan by na/(na - r_d)
    (40x on near-full-rank finishes).  Returns (compact, np_idx, cnt)."""
    cap, mwidth = Ud.shape
    slot = jnp.arange(cap, dtype=jnp.int32)
    live = slot < r_d
    pmask = jnp.zeros(mwidth, bool).at[
        jnp.where(live, pc_map, mwidth)].set(True, mode="drop")
    colid = jnp.arange(mwidth, dtype=jnp.int32)
    nonpiv = (~pmask) & (colid < na)
    np_idx = jnp.nonzero(nonpiv, size=ncols_cap, fill_value=mwidth)[0]
    ok = np_idx < mwidth
    compact = Ud[:, jnp.clip(np_idx, 0, mwidth - 1)]
    compact = jnp.where(ok[None, :] & live[:, None], compact, 0)
    return compact, np_idx, jnp.count_nonzero(compact)


def extract_u_csr(Ud, pc_map, r_d: int, na: int, piv_cols_loc):
    """Read the accumulated mutual-RREF panel back as scipy CSR
    (r_d, na): unit pivot entries are synthesized on the host from
    ``piv_cols_loc`` (slot order == Ud row order); only the non-pivot
    columns are scanned/transferred from the device."""
    import scipy.sparse as sp

    eye_r = np.arange(r_d, dtype=np.int64)
    eye_c = np.asarray(piv_cols_loc, np.int64)
    if r_d >= na:  # no non-pivot columns: U is exactly the identity part
        return sp.csr_matrix((np.ones(r_d, np.int64), (eye_r, eye_c)),
                             shape=(r_d, na))
    ncols_cap = _bucket(na - r_d)
    compact, np_idx, cnt = _compact_nonpivot(na, ncols_cap, Ud, pc_map,
                                             jnp.int32(r_d))
    nnz_c = int(cnt)
    er = ec = ev = np.zeros(0, np.int64)
    if nnz_c:
        ecap = max(128, 1 << int(nnz_c - 1).bit_length())
        er, ec, ev = (np.asarray(x) for x in extract_sparse(compact, ecap))
        np_idx = np.asarray(np_idx).astype(np.int64)
        keep = (er >= 0) & (er < r_d)
        er = er[keep].astype(np.int64)
        ec = np_idx[ec[keep]]
        ev = ev[keep].astype(np.int64)
    rows = np.concatenate([eye_r, er])
    cols_ = np.concatenate([eye_c, ec])
    vals = np.concatenate([np.ones(r_d, np.int64), ev])
    return sp.csr_matrix((vals, (rows, cols_)), shape=(r_d, na))


@functools.partial(jax.jit, static_argnums=(0, 1, 2),
                   donate_argnums=(6, 7))
def blocked_finish_step(f: Field, shape, panel: int,
                        rows, cols, vals, Ud, pc_map, r_d):
    """One fused device step of the blocked dense finish: densify the
    block's COO slice, eliminate it against the accumulated mutual-RREF
    panel Ud (rows beyond r_d are zero), run the Jordan RREF, back-
    eliminate Ud against the new pivots and append them.

    shape = (bs, na) static block shape; Ud (cap, na) with static
    capacity cap >= r_d + bs always (preallocated by the caller).
    pc_map (cap,) holds each pivot slot's column (0 for empty slots).
    Returns (Ud', pc_map', r_d', new_rank, prow_of, pcol_of).
    One jitted call per block — device round trips stay O(1) per block.
    """
    bs, na = shape
    cap = Ud.shape[0]
    from . import modmul
    from .matmul import modmatmul

    # .add so zero-padded COO entries (rows=cols=vals=0, used to bucket the
    # nnz shape and avoid per-block recompiles) are no-ops
    X = jnp.zeros((bs, na), jnp.int32).at[rows, cols].add(vals)
    coeff = X[:, pc_map]  # empty slots hit zero Ud rows
    X = modmul.sub(f, X, modmatmul(f, coeff, Ud))
    R, new_rank, prow_of, pcol_of, _ = rref_inplace(f, X, na, panel)
    nmax = prow_of.shape[0]  # = min(bs, na)
    if nmax < bs:
        prow_of = jnp.pad(prow_of, (0, bs - nmax), constant_values=-1)
        pcol_of = jnp.pad(pcol_of, (0, bs - nmax), constant_values=-1)
    # gather the new pivot rows, padded to the block height
    slot = jax.lax.broadcasted_iota(jnp.int32, (bs, 1), 0)[:, 0]
    live = slot < new_rank
    gather = jnp.where(live, jnp.clip(prow_of[:bs], 0, bs - 1), 0)
    newU = jnp.where(live[:, None], R[gather, :], 0)
    npc = jnp.where(live, jnp.clip(pcol_of[:bs], 0, na - 1), 0)
    # back-eliminate so the accumulated panel stays in full mutual RREF
    co = jnp.where(live[None, :], Ud[:, npc], 0)
    Ud = modmul.sub(f, Ud, modmatmul(f, co, newU))
    # append (rows beyond new_rank in newU are zero; capacity rows past
    # r_d + new_rank are zero either way)
    Ud = jax.lax.dynamic_update_slice(Ud, newU, (r_d, 0))
    pc_new = jnp.where(live, npc, 0)
    pc_map = jax.lax.dynamic_update_slice(pc_map, pc_new, (r_d,))
    return Ud, pc_map, r_d + new_rank, new_rank, prow_of, pcol_of


# element-count cap for the single-dispatch fused finish: the densified
# matrix (n_pad x na) must stay comfortably inside HBM next to the U panel
# and matmul transients (3e8 int32 elements = 1.2 GB)
FUSED_BUDGET = 300_000_000

# K-chunk size for the fused finish's masked eliminate / back-eliminate
# matmuls: the accumulated panel has only r_d live rows, so both big
# matmuls run a dynamic-trip-count loop over KC-row chunks and skip the
# dead tail (rows >= r_d are zero; empty pc_map slots hit zero Ud rows,
# so a partially-live chunk is exact).  The panel capacity is padded to a
# KC multiple.  Tests shrink this to cross chunk boundaries cheaply.
_FUSED_KC = 4096


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def fused_blocked_finish(f: Field, shape, npiv: int, bs: int, panel: int,
                         rows, cols, vals):
    """The entire blocked dense finish in ONE device dispatch: densify the
    COO once, then a device-resident loop over row blocks — eliminate the
    block against the accumulated mutual-RREF panel (one modular matmul),
    Jordan-RREF the block, back-eliminate the panel and append.  Same math
    as ``blocked_finish_step`` (which remains the streaming / low-rank
    variant); fusing the block loop removes the per-block dispatch and
    host round trip.

    shape = (n_pad, na) static with n_pad a multiple of bs; npiv <= na is
    the true (unpadded) column count — only those columns can hold pivots,
    and once they all do the block loop exits early.  Returns
    (Ud, pc_map, r_d, ranks, prows, pcols): Ud stays resident for sparse
    extraction; ranks/prows/pcols are (nblocks,)/(nblocks, bs) per-block
    pivot metadata (slot order = pivot-column order within the block).
    """
    n_pad, na = shape
    nblocks = n_pad // bs
    nmax = min(bs, npiv)
    KC = _FUSED_KC
    cap = -(-(_bucket(min(n_pad, npiv)) + bs) // KC) * KC
    X = jnp.zeros((n_pad, na), jnp.int32).at[rows, cols].add(vals)

    def body(carry):
        b, Ud, pc_map, r_d, ranks, prows, pcols = carry
        Xb0 = jax.lax.dynamic_slice(X, (b * bs, 0), (bs, na))
        nkc_live = (r_d + KC - 1) // KC

        def kbody(c, acc):
            start = c * KC
            pcc = jax.lax.dynamic_slice(pc_map, (start,), (KC,))
            Uc = jax.lax.dynamic_slice(Ud, (start, 0), (KC, na))
            coeff = Xb0[:, pcc]  # empty slots hit zero Ud rows
            return modmul.add(f, acc, modmatmul(f, coeff, Uc))

        corr = jax.lax.fori_loop(0, nkc_live, kbody,
                                 jnp.zeros((bs, na), jnp.int32))
        Xb = modmul.sub(f, Xb0, corr)
        R, new_rank, prow_of, pcol_of, _ = rref_inplace(f, Xb, npiv, panel)
        if nmax < bs:
            prow_of = jnp.pad(prow_of, (0, bs - nmax), constant_values=-1)
            pcol_of = jnp.pad(pcol_of, (0, bs - nmax), constant_values=-1)
        slot = jax.lax.broadcasted_iota(jnp.int32, (bs, 1), 0)[:, 0]
        live = slot < new_rank
        gather = jnp.where(live, jnp.clip(prow_of[:bs], 0, bs - 1), 0)
        newU = jnp.where(live[:, None], R[gather, :], 0)
        npc = jnp.where(live, jnp.clip(pcol_of[:bs], 0, na - 1), 0)

        # back-eliminate only the live rows of Ud (rows >= r_d are zero,
        # so skipped chunks are exact no-ops)
        def mbody(c, Ud):
            start = c * KC
            Udc = jax.lax.dynamic_slice(Ud, (start, 0), (KC, na))
            coc = jnp.where(live[None, :], Udc[:, npc], 0)
            Udc = modmul.sub(f, Udc, modmatmul(f, coc, newU))
            return jax.lax.dynamic_update_slice(Ud, Udc, (start, 0))

        Ud = jax.lax.fori_loop(0, nkc_live, mbody, Ud)
        Ud = jax.lax.dynamic_update_slice(Ud, newU, (r_d, 0))
        pc_map = jax.lax.dynamic_update_slice(
            pc_map, jnp.where(live, npc, 0), (r_d,))
        ranks = ranks.at[b].set(new_rank)
        prows = prows.at[b].set(prow_of[:bs])
        pcols = pcols.at[b].set(pcol_of[:bs])
        return b + 1, Ud, pc_map, r_d + new_rank, ranks, prows, pcols

    def cond(carry):
        b, _, _, r_d, _, _, _ = carry
        # once every true column holds a pivot no later block contributes
        return jnp.logical_and(b < nblocks, r_d < npiv)

    init = (jnp.int32(0),
            jnp.zeros((cap, na), jnp.int32),
            jnp.zeros((cap,), jnp.int32),
            jnp.int32(0),
            jnp.zeros((nblocks,), jnp.int32),
            jnp.zeros((nblocks, bs), jnp.int32),
            jnp.zeros((nblocks, bs), jnp.int32))
    _, Ud, pc_map, r_d, ranks, prows, pcols = jax.lax.while_loop(
        cond, body, init)
    return Ud, pc_map, r_d, ranks, prows, pcols


def _bucket(x: int) -> int:
    """Bucket device shapes so the jitted kernel compiles once per bucket:
    powers of two up to 1024, then multiples of 1024 (the n*m^2 elimination
    cost makes power-of-two padding waste up to 2.4x at large sizes)."""
    if x <= 1024:
        b = 128
        while b < x:
            b <<= 1
        return b
    return -(-x // 1024) * 1024


def rref(f: Field, X, want_transform: bool = False,
         panel: int = DEFAULT_PANEL, host_cutoff: "int | None" = None):
    """Host-facing dense RREF.  X: (n, m) array-like of balanced int32.

    Returns a dict with numpy results:
      R          (n, m) the reduced row echelon form (rows in original
                 positions — gather R[piv_rows] for the U factor)
      rank       int
      piv_rows   (rank,) row index of each pivot, in pivot-column order
      piv_cols   (rank,) strictly increasing pivot columns
      qinv       (m,) qinv[j] = k if column j holds pivot k else -1
                 (reference qinv semantics, src/SpaSM.jl:293-296)
      T          (n, n) transform with R = T @ X mod p (if requested)

    Small problems run on the host (NumPy); large ones on the device with
    power-of-two shape bucketing (zero padding is pivot-neutral).
    """
    X = np.asarray(X)
    n, m = X.shape
    if n == 0 or m == 0:
        return dict(R=np.zeros((n, m), np.int32), rank=0,
                    piv_rows=np.zeros(0, np.int64),
                    piv_cols=np.zeros(0, np.int64),
                    qinv=np.full(m, -1, np.int64),
                    T=np.eye(n, dtype=np.int32) if want_transform else None)
    if host_cutoff is None:
        host_cutoff = host_cutoff_for(f)
    if n * m < host_cutoff:
        return _host_rref(f, X, want_transform)
    panel = min(panel, max(8, m))
    nb, mb = _bucket(n), _bucket(m)
    Xp = f.normalize(X).astype(np.int32)
    if (nb, mb) != (n, m):
        Xp = np.pad(Xp, ((0, nb - n), (0, mb - m)))
    Xd = jnp.asarray(Xp)
    R, rank, prow_of, pcol_of, is_piv, T = _rref_jit(
        f, Xd, mb, panel, want_transform)
    rank = int(rank)
    piv_rows = np.asarray(prow_of)[:rank].astype(np.int64)
    piv_cols = np.asarray(pcol_of)[:rank].astype(np.int64)
    qinv = np.full(m, -1, np.int64)
    qinv[piv_cols] = np.arange(rank)
    return dict(R=np.asarray(R)[:n, :m], rank=rank, piv_rows=piv_rows,
                piv_cols=piv_cols, qinv=qinv,
                T=np.asarray(T)[:n, :n] if want_transform else None)


def _host_rref(f: Field, X, want_transform: bool):
    """NumPy Gauss-Jordan mod p — exact int64, same output contract.

    Each step touches only the columns from the pivot row's first
    nonzero on.  When min(n, m) * (p/2)**2 fits int64 (tier-A primes),
    the other rows are reduced lazily: only the pivot column and the
    pivot row are normalized per step, each entry growing by at most
    (p/2)**2 per pivot, and everything is normalized once at the end."""
    n, m = X.shape
    A = f.normalize(X).astype(np.int64)
    if want_transform:
        A = np.hstack([A, np.eye(n, dtype=np.int64)])
    lazy = min(n, m) * f.halfp * f.halfp < (1 << 62)
    is_piv = np.zeros(n, bool)
    piv_rows, piv_cols = [], []
    for j in range(m):
        if lazy:
            A[:, j] = f.normalize(A[:, j])
        cand = np.flatnonzero((A[:, j] != 0) & ~is_piv)
        if cand.size == 0:
            continue
        pr = int(cand[0])
        row = f.normalize(A[pr]) if lazy else A[pr]
        row = f.mul(row, int(f.inv(row[j])))
        A[pr] = row
        coef = A[:, j].copy()
        coef[pr] = 0
        rows = np.flatnonzero(coef)
        if rows.size:
            # columns from the pivot row's first nonzero on; every row at
            # once (no gather) when most rows need the update
            c0 = int(np.flatnonzero(row)[0])
            idx = (slice(None) if 2 * rows.size > n else rows,
                   slice(c0, None))
            cf = coef[idx[0], None]
            upd = A[idx] - cf * row[None, c0:]
            A[idx] = upd if lazy else f.normalize(upd)
        is_piv[pr] = True
        piv_rows.append(pr)
        piv_cols.append(j)
    if lazy:
        A = f.normalize(A)
    rank = len(piv_rows)
    qinv = np.full(m, -1, np.int64)
    qinv[piv_cols] = np.arange(rank)
    return dict(R=A[:, :m].astype(np.int32), rank=rank,
                piv_rows=np.array(piv_rows, np.int64),
                piv_cols=np.array(piv_cols, np.int64), qinv=qinv,
                T=A[:, m:].astype(np.int32) if want_transform else None)
