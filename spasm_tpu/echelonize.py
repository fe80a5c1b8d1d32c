"""Multi-round echelonization driver — the heart of the framework.

Mirrors the observable algorithm of ``spasm_echelonize``
(src/SpaSM.jl:815-866, README.md:19-38):

    round k: structural pivot search (FL + greedy completion, pivots.py)
             -> if enough pivots: form the Schur complement of the
                remaining rows and recurse on it
    stop:    not enough pivots (min_pivot_proportion) or max_round
    finish:  by density / aspect ratio: dense device RREF (the FFPACK
             replacement, ops/dense.py) or GPLU-style sparse left-looking
             elimination (host, for very sparse tails)

All elimination runs through the level-wave machinery (elimination.py), so
the global pivot list — structural pivots of every round, then finishing
pivots — is one append-invariant sequence usable as a static elimination
order (no per-row DFS).

The result ``LU`` matches the reference's semantics (src/SpaSM.jl:262-305):
U is r x m with unit pivots located by qinv (qinv[j] = pivot index in
column j or -1), p maps U rows to original A rows, and L (optional,
``opts.L``) satisfies A == L @ U exactly mod p.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import warnings

import numpy as np
import scipy.sparse as sp

from .csr import SparseGFp
from .elimination import (compute_levels, eliminate_against_reduced,
                          mutual_reduce, wave_eliminate)
from .field import Field
from .ops import dense as dense_ops
from .pivots import find_structural_pivots
from .sputil import mod_reduce
from .utils.logging import is_verbose, log, push_verbose, wtime


@dataclasses.dataclass
class EchelonizeOptions:
    """The reference's 13-field options struct (src/SpaSM.jl:325-343).
    Defaults chosen to match the reference's observable behavior; flag
    names are kept verbatim."""

    enable_greedy_pivot_search: bool = True
    enable_tall_and_skinny: bool = True
    enable_dense: bool = True
    enable_GPLU: bool = True
    L: bool = False
    complete: bool = False
    min_pivot_proportion: float = 0.1
    max_round: int = 3
    sparsity_threshold: float = 0.05
    dense_block_size: int = 1000
    low_rank_ratio: float = 0.5
    tall_and_skinny_ratio: float = 5.0
    low_rank_start_weight: float = -1.0

    # Accelerator knob: max dense elements for the device finish.
    # None = auto: ~35% of the accelerator's memory limit in int32
    # elements (the blocked finish holds the U panel (cap x na) plus one
    # block and the matmul limb transients), floor 2e8 (also the CPU
    # value).
    dense_budget: "int | None" = None
    # Accelerator knob: run the round Schur updates on the device
    # (ops/sparse_onepass, with the sparse_device waves as overflow
    # fallback) above this nnz; 0 disables.  Requires opts.L == False
    # (coefficient recording stays on host).  Default 0: on the first
    # (non-GPU) accelerator the sort-based device paths lost to the OpenMP
    # host Schur kernel on every real round workload (tools/
    # device_crossover.py; git history); not measured on H100.
    device_sparse_min_nnz: int = 0
    # Accelerator knob: on an accelerator backend, switch to the dense
    # finish at a LOWER estimated Schur density whenever it fits the
    # dense budget — exact int8 matrix products make the dense finish far
    # cheaper relative to sparse fill growth than the CPU tradeoff the
    # reference's 0.05 sparsity_threshold was tuned for (a 50k/1.2e-4
    # random case exploded 1.5M -> 26M nnz in the round the 0.05 gate let
    # through).  The value 0.02 is kept from the first (non-GPU) tuning;
    # not measured on H100.  None disables (reference behavior).
    device_sparsity_threshold: "float | None" = 0.02
    # Markowitz-style fill filter: when a sparse round's PREDICTED fill
    # (est * rest * cols) exceeds this multiple of the current nnz, drop
    # the selected pivots whose Markowitz cost (row_len-1)*(col_count-1)
    # exceeds 2x the round's median — high-cost pivots defer to later,
    # sparser rounds.  On the irregular subcomplex boundary it cut
    # round-0 fill 4.9M -> ~1-2.4M (git history); uniform-cost instances
    # (full-simplex boundaries) keep
    # every pivot (ties at the median) and never pay the O(nnz) count
    # pass (the trigger stays cold).  None disables.
    pivot_fill_filter: "float | None" = 4.0
    # (the round-2/3 experimental fully-device-resident FL round loop —
    # ops/resident.py, options device_rounds / device_rounds_max_pool —
    # was retired in round 4: chip-validated but it lost to the host
    # round loop at every validated pool size, with no winning regime in
    # sight; see git history for the measurements)


def parse_echelonize_opts(opts=None, **kwargs) -> EchelonizeOptions:
    opts = dataclasses.replace(opts) if opts else EchelonizeOptions()
    for k, v in kwargs.items():
        if not hasattr(opts, k):
            raise TypeError(f"unknown echelonize option {k!r}")
        setattr(opts, k, v)
    if opts.dense_budget is None:
        opts.dense_budget = _auto_dense_budget()
    return opts


_AUTO_DENSE_BUDGET = None


def _auto_dense_budget() -> int:
    """dense_budget resolution: scale with the accelerator's memory limit
    (cached; one query per process).  A non-CPU device that reports no
    memory limit is an error: no size is assumed for an unknown device."""
    global _AUTO_DENSE_BUDGET
    if _AUTO_DENSE_BUDGET is None:
        import jax

        budget = 200_000_000
        dev = jax.devices()[0]
        if dev.platform != "cpu":
            limit = (dev.memory_stats() or {}).get("bytes_limit")
            if not limit:
                raise RuntimeError(
                    f"{dev.platform} device {dev.device_kind!r} reports no "
                    "memory limit; pass dense_budget explicitly")
            budget = max(budget, int(limit * 0.35) // 4)
        _AUTO_DENSE_BUDGET = budget
    return _AUTO_DENSE_BUDGET


@dataclasses.dataclass
class LU:
    """Echelonization result (the reference's spasm_lu, src/SpaSM.jl:262).

    U rows are listed in elimination (pivot) order; ``levels`` caches the
    wave schedule for later solves."""

    field: Field
    n: int                 # rows of the original A
    m: int                 # cols of the original A
    r: int                 # rank
    complete: bool
    U: SparseGFp           # (r, m) unit pivots
    qinv: np.ndarray       # (m,) column -> pivot index or -1
    p: np.ndarray          # (r,) pivot index -> original row of A
    piv_cols: np.ndarray   # (r,) pivot index -> column
    L: "SparseGFp | None"  # (n, r) with A == L @ U, if requested
    # (r,) wave level of each pivot — computed lazily on first use (the
    # solve paths need it; a rank-only call never pays for it)
    _levels: "np.ndarray | None" = None
    # pivots >= dense_piv_start come from the dense (Jordan RREF) finish:
    # their L[p] block is a general invertible matrix, not triangular —
    # solves treat it densely (solve.py).  None = no dense block.
    dense_piv_start: "int | None" = None
    # (r,) slot permutation under which L[p] is lower-triangular: rounds
    # whose L was recorded against the REDUCED pivot block have an
    # upper-triangular diagonal block (slot order reversed there).  None =
    # identity (wave-recorded / GPLU / no L).
    lp_order: "np.ndarray | None" = None

    @property
    def rank(self) -> int:
        return self.r

    @property
    def levels(self) -> np.ndarray:
        if self._levels is None:
            self._levels = compute_levels(self.U, self.piv_cols)
        return self._levels

    def __repr__(self):
        return (f"LU: rank {self.r}, complete {self.complete}, "
                f"U {self.U.shape}, L "
                f"{self.L.shape if self.L is not None else None}")


_LAST_STATS: dict = {}


def last_phase_stats() -> dict:
    """Per-phase wall attribution of the most recent ``echelonize`` call
    in this process: pivot_s (structural pivot search), schur_s (density
    estimate + mutual reduce + Schur updates), finish_s (dense/GPLU
    finish), assemble_s (U/qinv/L assembly), device_s (wall spent inside
    device-dispatch paths — the sparse device Schur and the device dense
    finish), total_s, and device_share = device_s / total_s.  bench.py
    records it beside its walls."""
    return dict(_LAST_STATS)


def echelonize(A: SparseGFp, opts: EchelonizeOptions | None = None,
               verbose=False, checkpoint: str | None = None,
               resume: str | None = None, mesh=None, **kwargs) -> LU:
    """Echelonize A (src/SpaSM.jl:860-866).  `verbose` may be a bool or an
    nnz threshold (reference semantics: verbose = nnz(A) >= threshold).

    checkpoint: path to persist round-granular state after every round
    (checkpoint.py); resume: path of a previous checkpoint to continue
    from (the same A must be passed).  mesh: a jax.sharding.Mesh — round
    Schur updates then run row-sharded on device
    (parallel/sparse_sharded), falling back to host waves on capacity
    overflow."""
    opts = parse_echelonize_opts(opts, **kwargs)
    if not isinstance(verbose, bool):
        verbose = A.nnz >= verbose
    with push_verbose(verbose):
        return _echelonize_impl(A, opts, checkpoint, resume, mesh)


def _echelonize_impl(A: SparseGFp, opts: EchelonizeOptions,
                     checkpoint: str | None = None,
                     resume: str | None = None, mesh=None) -> LU:
    f = A.field
    n, m = A.shape
    t_start = wtime()
    stats = {"pivot_s": 0.0, "schur_s": 0.0, "finish_s": 0.0,
             "assemble_s": 0.0, "device_s": 0.0}
    log(f"[echelonize] Start on {n} x {m} matrix with {A.nnz} nnz")

    # SparseGFp is canonical by construction (balanced values, sorted
    # indices, no explicit zeros): no entry re-reduction needed
    S = A.to_scipy()                    # current Schur complement
    row_origin = np.arange(n, dtype=np.int64)

    U_blocks: list[sp.csr_matrix] = []  # scaled pivot row blocks
    piv_cols_all: list[np.ndarray] = []
    piv_origin_all: list[np.ndarray] = []
    L_parts: list[tuple] = []           # (rows_orig, piv_idx, value)
    # rounds whose L was recorded against the REDUCED pivot block: their
    # (start, npiv) slot ranges have an upper-triangular L block that the
    # solves handle by reversing the slot order (LU.lp_order)
    L_rev_segments: list[tuple[int, int]] = []
    r = 0

    round_idx = 0
    dense_resume = None
    if resume:
        from . import checkpoint as ckpt

        state = ckpt.load_state(resume)
        if state["field_p"] != f.p:
            raise ValueError("checkpoint prime differs from matrix prime")
        S = state["S"]
        row_origin = state["row_origin"]
        r = state["r"]
        round_idx = state["round_idx"]
        if r:
            U_blocks.append(state["U"])
            piv_cols_all.append(state["piv_cols"])
            piv_origin_all.append(state["piv_origin"])
        L_parts.extend(state["L_parts"])
        L_rev_segments.extend(state.get("L_rev_segments", []))
        log(f"[echelonize] resumed at round {round_idx}, rank {r}")
        # block-granular dense-finish sidecar: resume mid-finish if one
        # was saved (validated in _dense_finish_blocked against the actual
        # finish inputs, so a stale sidecar is ignored, not resumed)
        if os.path.exists(resume + ".dense"):
            dense_resume = ckpt.load_dense_state(resume + ".dense")
            log(f"[echelonize] dense-finish sidecar found "
                f"(b0={dense_resume['b0']}, "
                f"{len(dense_resume['piv_cols_loc'])} pivots)")

    if checkpoint and not resume:
        # initial checkpoint: a run that dense-switches at round 0 (or
        # crashes mid-round) still leaves a resumable state on disk
        _save_checkpoint(checkpoint, f, opts, round_idx, r, S, row_origin,
                         m, U_blocks, piv_cols_all, piv_origin_all, L_parts)

    dense_piv_start0 = None

    force_dense = False  # set when a round's density gate trips
    fill_filter_rejects = 0  # Markowitz probe strikes (2 = stop probing)
    while round_idx < opts.max_round:
        if S.shape[0] == 0 or S.nnz == 0:
            break
        log(f"[echelonize] round {round_idx}")
        Sw = SparseGFp.from_scipy(S, f.p, assume_canonical=True)
        t0 = wtime()
        fl = None
        col_election = None
        if mesh is not None:
            # distributed FL-rows AND FL-cols elections over the mesh
            # (pmin all-reduces); both bit-identical to the host
            # strategies, so the greedy completion below proceeds
            # unchanged on the (small) residual
            from .parallel.sparse_sharded import (sharded_fl_col_election,
                                                  sharded_fl_election)

            fl = sharded_fl_election(f, mesh, Sw)
            col_election = functools.partial(
                sharded_fl_col_election, f, mesh, Sw)
        # (measured: skipping the greedy's sequential mop-up here to save
        # ~0.1 s of host Python flips the round-0 density gate on
        # knife-edge instances — fewer pivots => lower estimated density
        # => a host Schur round that costs more than the mop-up saved —
        # so the full search always runs)
        prows, pcols, counts = find_structural_pivots(
            Sw, enable_greedy=opts.enable_greedy_pivot_search, fl=fl,
            col_election=col_election)
        log(f"[pivots] Faugère-Lachartre: {counts['faugere-lachartre']} "
            f"pivots found [{wtime() - t0:.1f}s]")
        log(f"[pivots] ``Faugère-Lachartre on columns'': "
            f"{counts['faugere-lachartre-cols']} pivots found "
            f"[{wtime() - t0:.1f}s]")
        log(f"[pivots] greedy cycle-free completion: {counts['greedy']} "
            f"pivots found [{wtime() - t0:.1f}s]")
        log(f"[pivots] {prows.size} pivots found")
        stats["pivot_s"] += wtime() - t0
        npiv = prows.size
        row_lens = np.diff(S.indptr)
        nrows_active = int((row_lens > 0).sum())
        minkeep = opts.min_pivot_proportion * max(
            1, min(nrows_active, S.shape[1]))
        if npiv < minkeep:
            log("[echelonize] not enough pivots found; stopping")
            break

        t0 = wtime()
        # Monte-Carlo density estimate BEFORE paying for the full Schur:
        # if the complement would densify past sparsity_threshold, skip
        # this round and let the dense finish take the current S (the
        # reference's est_density gate, src/SpaSM.jl:763)
        # the materialized rest-row slice is only needed by the L path,
        # the device/mesh sparse path and the wave fallback — the plain
        # rank path eliminates straight off S via the kernel's row
        # indirection, skipping a tens-of-MB gather per round
        need_rest = (opts.L or mesh is not None
                     or bool(opts.device_sparse_min_nnz))
        est, S_rest, rest_rows, blk = _round_schur_estimate(
            f, S, prows, pcols, need_rest=need_rest)
        Upart, piv_vals, levels_blk = blk
        del blk
        log(f"Schur complement is {rest_rows.size} x {S.shape[1]}, "
            f"estimated density : {est:.2f}")
        thresh = opts.sparsity_threshold
        if (opts.device_sparsity_threshold is not None and opts.enable_dense
                and opts.device_sparsity_threshold <= est < thresh
                and _on_accelerator() and _dense_feasible(S, opts)):
            # evaluated lazily: _dense_feasible's O(nnz) alive-column scan
            # only runs when the lowered gate could actually change the
            # decision (est already known >= the device threshold)
            thresh = min(thresh, opts.device_sparsity_threshold)
        if (est >= thresh and opts.enable_dense
                and (round_idx > 0 or _dense_feasible(S, opts))):
            # round 0 included when the whole matrix fits the dense budget:
            # one blocked device RREF beats forming a dense-ish sparse Schur
            # on the host (the reference's spasm_schur_dense role,
            # src/SpaSM.jl:765)
            log("[echelonize] Schur complement too dense; "
                "switching to dense finish")
            force_dense = True
            break
        if (opts.pivot_fill_filter and fill_filter_rejects < 2
                and est * rest_rows.size * S.shape[1]
                > opts.pivot_fill_filter * max(1, S.nnz)):
            # predicted fill blow-up: drop the high-Markowitz-cost pivots
            # (they defer to later, sparser rounds) and re-partition
            cc = np.bincount(S.indices, minlength=S.shape[1])
            cost = ((row_lens[prows] - 1)
                    * (cc[pcols] - 1)).astype(np.float64)
            keep = cost <= 2.0 * max(1.0, float(np.median(cost)))
            if keep.sum() >= minkeep and not keep.all():
                # accept the filtered set only if it meaningfully cuts
                # the predicted fill — structureless instances (random)
                # gain nothing from deferral and would pay extra rounds
                pr2, pc2 = prows[keep], pcols[keep]
                est2, S_rest2, rest2, blk2 = _round_schur_estimate(
                    f, S, pr2, pc2, need_rest=need_rest)
                if est2 * rest2.size <= 0.75 * est * rest_rows.size:
                    log(f"[pivots] fill filter: deferring "
                        f"{int((~keep).sum())} high-fill pivots "
                        f"(predicted fill {est * rest_rows.size:.0f} -> "
                        f"{est2 * rest2.size:.0f} row-equivalents)")
                    prows, pcols = pr2, pc2
                    npiv = prows.size
                    est, S_rest, rest_rows = est2, S_rest2, rest2
                    Upart, piv_vals, levels_blk = blk2
                else:
                    # structureless: deferral didn't cut fill — after two
                    # rejections stop paying the probe for this run
                    fill_filter_rejects += 1
                del blk2
        S_new = C = None
        ok = False  # reduced-block flag (host path sets it)
        reduced_L = False
        piv_L = None
        use_device_sparse = (
            not opts.L
            and ((mesh is not None)
                 or (opts.device_sparse_min_nnz
                     and S_rest.nnz >= opts.device_sparse_min_nnz)))
        if use_device_sparse:
            # the device path wants the SparseGFp view of the pivot block
            # (built lazily — the host path never needs it)
            t_dev = wtime()
            Ublock_w = SparseGFp.from_scipy(Upart, f.p,
                                            assume_canonical=True)
            S_new = _device_sparse_schur(f, mesh, Ublock_w, pcols,
                                         levels_blk, S_rest)
            stats["device_s"] += wtime() - t_dev
            if S_new is not None:
                S_new = S_new.to_scipy()
        if S_new is None:  # host path (also the overflow fallback)
            # mutual-reduce the round's pivot block once (backward sweep
            # over npiv rows), then the Schur update of the q >> npiv
            # remaining rows is a single product (elimination.py).  With
            # an L factor requested, every row's coefficients against the
            # REDUCED block are simply its values at the pivot columns
            # (unique expression in a mutual-RREF basis), so L is recorded
            # directly; the round's own L block becomes UPPER-triangular
            # in slot order (append invariant: a pivot row only touches
            # its own and LATER pivot columns), which the solves handle by
            # reversing the slot order within the block (LU.lp_order,
            # solve.py `_solve_zLp`).
            Ustar, ok = mutual_reduce(f, Upart, pcols, levels_blk)
            if ok:
                if opts.L:
                    # pivot rows' coefficients vs the reduced block,
                    # sliced off the ORIGINAL rows (scaled block times
                    # piv_vals) before Upart is replaced
                    cmap = np.full(S.shape[1], -1, np.int64)
                    cmap[pcols] = np.arange(npiv)
                    Uc = sp.coo_matrix(Upart)
                    pm = cmap[Uc.col] >= 0
                    piv_L = (row_origin[prows][Uc.row[pm]],
                             r + cmap[Uc.col[pm]],
                             f.normalize(Uc.data[pm].astype(np.int64)
                                         * piv_vals[Uc.row[pm]]))
                    reduced_L = True
                if S_rest is not None:
                    S_new, C = eliminate_against_reduced(
                        f, Ustar, pcols, S_rest, record_coeffs=opts.L,
                        assume_canonical=True)
                else:
                    S_new, C = eliminate_against_reduced(
                        f, Ustar, pcols, S, record_coeffs=False,
                        assume_canonical=True, rows=rest_rows)
                Upart = Ustar  # store the reduced block as U (valid
                # echelon form)
            else:  # fill blow-up guard: wave cascade
                if S_rest is None:
                    S_rest = _gather_rest(S, rest_rows)
                S_new, C = wave_eliminate(f, Upart, pcols, levels_blk,
                                          S_rest, record_coeffs=opts.L,
                                          assume_canonical=True)
        dens = S_new.nnz / max(1, S_new.shape[0] * S_new.shape[1])
        log(f"Schur complement: {S_new.shape[0]} * {S_new.shape[1]} "
            f"[{S_new.nnz} nz / density= {dens:.3f}], "
            f"{wtime() - t0:.1f}s")
        stats["schur_s"] += wtime() - t0

        if opts.L:
            if reduced_L:
                L_parts.append(piv_L)
                L_rev_segments.append((r, npiv))
            else:
                # pivot rows: a_orig = pivot_val * u_k (self coefficient)
                L_parts.append((row_origin[prows], r + np.arange(npiv),
                                piv_vals))
            Cc = C.tocoo()
            L_parts.append((row_origin[rest_rows][Cc.row], r + Cc.col,
                            Cc.data))

        U_blocks.append(Upart)
        piv_cols_all.append(pcols.astype(np.int64))
        piv_origin_all.append(row_origin[prows])
        r += npiv
        S = S_new
        row_origin = row_origin[rest_rows]
        round_idx += 1
        if checkpoint:
            _save_checkpoint(checkpoint, f, opts, round_idx, r, S,
                             row_origin, m, U_blocks, piv_cols_all,
                             piv_origin_all, L_parts, L_rev_segments)

    # ---------------- finish ----------------
    t_finish = wtime()
    if S.shape[0] and S.nnz:
        nrows = int((np.diff(S.indptr) > 0).sum())
        alive_mask = np.zeros(S.shape[1], bool)
        alive_mask[S.indices] = True
        alive_cols = np.flatnonzero(alive_mask)
        dens = S.nnz / max(1, nrows * alive_cols.size)
        aspect = S.shape[0] / max(1, S.shape[1])
        log(f"[echelonize] finishing; density = {dens:.3f}; "
            f"aspect ratio = {aspect:.1f}")
        dense_elems = nrows * alive_cols.size
        dense_piv_start = dense_piv_start0
        # blocked dense memory needs O((block + rank_tail) * na), not
        # O(nrows * na) — tall matrices are always dense-finishable
        na = alive_cols.size
        # on an accelerator the dense finish's density gate drops to
        # device_sparsity_threshold, like the round loop's dense switch:
        # a knife-edge tail (e.g. dens = 0.0499 vs threshold 0.05) cost
        # ~13x more in host GPLU than in the device finish on the first
        # (non-GPU) accelerator (git history); not measured on H100
        thresh_fin = opts.sparsity_threshold
        if (opts.device_sparsity_threshold is not None and opts.enable_dense
                and _on_accelerator()):
            thresh_fin = min(thresh_fin, opts.device_sparsity_threshold)
        use_dense = (opts.enable_dense
                     and (opts.dense_block_size + min(nrows, na)) * na
                     <= opts.dense_budget
                     and (force_dense
                          or dens >= thresh_fin
                          or not opts.enable_GPLU
                          or dense_elems <= 1_000_000
                          or (opts.enable_tall_and_skinny
                              and nrows > opts.tall_and_skinny_ratio * na)))
        if use_dense:
            # a resume-only run keeps checkpointing (and finally cleans)
            # the sidecar it was resumed from
            ckpt_base = checkpoint or resume
            blk = _dense_finish_blocked(
                f, S, row_origin, alive_cols, r, opts, L_parts,
                ckpt_path=(ckpt_base + ".dense" if ckpt_base else None),
                dense_resume=dense_resume)
            if blk is not None:
                dense_piv_start = r
        else:
            if not opts.enable_GPLU:
                # reference semantics allow disabling both finishes, but an
                # unfinished tail would silently under-report the rank; GPLU
                # is our mandatory fallback (announced, not silent)
                log("[echelonize] enable_GPLU=False but the dense finish is "
                    "unavailable (enable_dense/dense_budget); falling back "
                    "to GPLU anyway")
            blk = _gplu_finish(f, S, row_origin, r, opts, L_parts)
        if blk is not None:
            Upart, pcols, porig = blk
            U_blocks.append(Upart)
            piv_cols_all.append(pcols)
            piv_origin_all.append(porig)
            r += pcols.size
    else:
        dense_piv_start = dense_piv_start0
    stats["finish_s"] = wtime() - t_finish

    # ---------------- assemble ----------------
    t_assemble = wtime()
    if U_blocks:
        U_sp = sp.vstack([sp.csr_matrix(b) for b in U_blocks], format="csr")
        piv_cols = np.concatenate(piv_cols_all)
        p_vec = np.concatenate(piv_origin_all)
    else:
        U_sp = sp.csr_matrix((0, m), dtype=np.int64)
        piv_cols = np.zeros(0, np.int64)
        p_vec = np.zeros(0, np.int64)
    # every finish block is canonical csr (mod_reduce output, the dense
    # finish's COO->csr construction, or GPLU's mod_reduce), and vstack
    # preserves per-row order — skip the re-canonicalization lexsort
    # (1s+ at millions of nnz)
    U = SparseGFp.from_scipy(U_sp, f.p, assume_canonical=True)
    qinv = np.full(m, -1, np.int64)
    qinv[piv_cols] = np.arange(r)

    L = None
    lp_order = None
    if opts.L:
        # rows of A that eliminated to zero contribute their recorded
        # coefficient rows; all parts were accumulated in L_parts
        if L_parts:
            li = np.concatenate([np.asarray(t[0], np.int64) for t in L_parts])
            lj = np.concatenate([np.asarray(t[1], np.int64) for t in L_parts])
            lv = np.concatenate([np.asarray(t[2], np.int64) for t in L_parts])
        else:
            li = lj = lv = np.zeros(0, np.int64)
        L = SparseGFp.from_coo(f, n, r, li, lj, lv, sum_duplicates=False)
        if L_rev_segments:
            # reversing the slot order inside reduced-recorded rounds makes
            # L[p] lower-triangular again (see round loop / solve._solve_zLp)
            lp_order = np.arange(r, dtype=np.int64)
            for s0, ln in L_rev_segments:
                lp_order[s0:s0 + ln] = lp_order[s0:s0 + ln][::-1]

    fact = LU(field=f, n=n, m=m, r=r, complete=False, U=U, qinv=qinv,
              p=p_vec, piv_cols=piv_cols, L=L,
              dense_piv_start=dense_piv_start, lp_order=lp_order)
    if opts.complete:
        from .solve import rref_of_U, rref_qinv_of  # cycle-free import

        # the canonical RREF's pivot columns are its rows' leading columns
        # (they can differ from the factorization's pivot choices); against
        # an RREF any row's elimination coefficients are its values at the
        # pivot columns, so L becomes a column selection of A.
        R = rref_of_U(fact)
        qinv_c = rref_qinv_of(R)
        piv_cols_c = np.flatnonzero(qinv_c >= 0)[
            np.argsort(qinv_c[qinv_c >= 0], kind="stable")]
        L_c = None
        if opts.L:
            sel = np.full(m, -1, np.int64)
            sel[piv_cols_c] = np.arange(r)
            L_c = A.select_cols(sel, r)
        # provenance: RREF rows are combinations, keep the original pivot
        # rows sorted by their columns as representatives
        order = np.argsort(piv_cols, kind="stable")
        fact = dataclasses.replace(
            fact, U=R, complete=True, qinv=qinv_c, piv_cols=piv_cols_c,
            p=p_vec[order], _levels=np.zeros(r, np.int64), L=L_c,
            dense_piv_start=0 if opts.L else None,  # L_c is not triangular
            lp_order=None)
    stats["assemble_s"] = wtime() - t_assemble
    stats["total_s"] = wtime() - t_start
    stats["device_s"] += _drain_device_finish_wall()
    stats["device_share"] = (stats["device_s"] / stats["total_s"]
                             if stats["total_s"] else 0.0)
    global _LAST_STATS
    _LAST_STATS = {k: round(v, 4) for k, v in stats.items()}
    log(f"[echelonize] Done in {wtime() - t_start:.1f}s. Rank {r}, "
        f"{U.nnz} nz in basis")
    return fact


_DEVICE_FINISH_WALL = [0.0]


def _drain_device_finish_wall() -> float:
    """Wall accumulated inside the device dense-finish loops since the
    last drain (set by _blocked_device_loop / _fused_device_finish /
    _dense_finish_from_device)."""
    v = _DEVICE_FINISH_WALL[0]
    _DEVICE_FINISH_WALL[0] = 0.0
    return v


def _save_checkpoint(path, f, opts, round_idx, r, S, row_origin, m,
                     U_blocks, piv_cols_all, piv_origin_all, L_parts,
                     L_rev_segments=()):
    from . import checkpoint as ckpt

    U_cat = sp.vstack(U_blocks, format="csr") if U_blocks else \
        sp.csr_matrix((0, m), dtype=np.int64)
    ckpt.save_state(
        path, field_p=f.p, round_idx=round_idx, r=r, S=S,
        row_origin=row_origin, U_sp=U_cat,
        piv_cols=(np.concatenate(piv_cols_all) if piv_cols_all
                  else np.zeros(0, np.int64)),
        piv_origin=(np.concatenate(piv_origin_all)
                    if piv_origin_all else np.zeros(0, np.int64)),
        opts_dict={k: v for k, v in dataclasses.asdict(opts).items()
                   if isinstance(v, (int, float, bool))},
        L_parts=L_parts if opts.L else None,
        L_rev_segments=L_rev_segments if opts.L else ())
    log(f"[echelonize] checkpoint saved at round {round_idx}")


def _gather_rest(S, rest_rows):
    from .native import gather_rows_native

    out = gather_rows_native(S, rest_rows)
    return out if out is not None else sp.csr_matrix(S[rest_rows])


def _round_schur_estimate(f: Field, S, prows, pcols, need_rest=True):
    """Scale the round's pivot rows to unit pivots, derive the block's
    elimination levels, split off the non-pivot rows, and Monte-Carlo
    estimate the Schur complement density (the reference's
    spasm_schur_estimate_density gate, src/SpaSM.jl:763).  Returns
    (est, S_rest, rest_rows, (Upart, piv_vals, levels_blk)); with
    need_rest=False, S_rest is None (the estimate samples straight off S
    via rest_rows and the caller eliminates via the kernel's row
    indirection instead of a materialized gather)."""
    from .native import gather_rows_native, scale_rows_native

    npiv = prows.size
    Upart = gather_rows_native(S, prows)  # (npiv, m) in pivot order
    if Upart is None:
        Upart = sp.csr_matrix(S[prows])
    # pivot values: FL pivots sit at their row's LEFTMOST entry (the vast
    # majority — all of them on boundary-class rounds), readable straight
    # off the CSR; only the general (greedy/FL-col) pivots need scipy's
    # slow 2D fancy indexing
    row_starts = Upart.indptr[:-1]
    is_left = Upart.indices[row_starts] == pcols
    piv_vals = np.empty(npiv, np.int64)
    piv_vals[is_left] = Upart.data[row_starts[is_left]]
    rest = np.flatnonzero(~is_left)
    if rest.size:
        piv_vals[rest] = np.asarray(
            Upart[rest, pcols[rest]]).ravel().astype(np.int64)
    if piv_vals.size and np.abs(piv_vals).max() <= 1:
        # +-1 pivots (boundary matrices, the reference's real domain):
        # the inverse equals the value, and multiplying balanced data by
        # +-1 stays balanced — skip the Fermat inverses AND the normalize
        # pass (~0.6 s at 20M pivot-block nnz)
        scales, norm = piv_vals, False
    else:
        scales, norm = f.inv(piv_vals), True
    if scale_rows_native(f, Upart, scales, norm) is None:
        row_of_entry = np.repeat(np.arange(npiv), np.diff(Upart.indptr))
        if norm:
            Upart.data = f.normalize(Upart.data * scales[row_of_entry])
        else:
            Upart.data = Upart.data * scales[row_of_entry]
    # New-block levels are self-contained: S rows already have zeros at
    # all earlier pivot columns, so cross-block edges cannot exist here.
    levels_blk = compute_levels(Upart, pcols)
    rest_mask = np.ones(S.shape[0], bool)
    rest_mask[prows] = False
    rest_rows = np.flatnonzero(rest_mask)
    if need_rest:
        S_rest = gather_rows_native(S, rest_rows)
        if S_rest is None:
            S_rest = S[rest_rows]
        est = schur_estimate_density(f, Upart, pcols, levels_blk, S_rest)
    else:
        S_rest = None
        est = schur_estimate_density(f, Upart, pcols, levels_blk, S,
                                     rest_rows=rest_rows)
    return est, S_rest, rest_rows, (Upart, piv_vals, levels_blk)


def _on_accelerator() -> bool:
    import jax

    return jax.default_backend() != "cpu"


def _dense_feasible(S, opts) -> bool:
    """Would the blocked dense finish fit the dense budget for S?  Same
    memory model as the finish dispatch: O((block + rank_tail) * na).

    On an accelerator backend the exact int8 matrix product makes a
    round-0 dense switch cheap at any budget-fitting size; with CPU-only
    jax (tests, emulation) the blocked device loop is orders of magnitude
    slower, so the early switch is only taken at host-RREF-friendly
    sizes."""
    import jax

    nrows = int((np.diff(S.indptr) > 0).sum())
    # alive-column COUNT via a boolean mask: np.unique's sort costs >1 s
    # at 50M nnz, the mask is a single O(nnz) pass
    alive = np.zeros(S.shape[1], bool)
    alive[S.indices] = True
    na = int(alive.sum())
    budget = opts.dense_budget
    if jax.default_backend() == "cpu":
        budget = min(budget, 2_000_000)
    return (opts.dense_block_size + min(nrows, na)) * na <= budget


def _device_sparse_schur(f: Field, mesh, U, pcols, levels, S_rest_sp):
    """Round Schur update on device.

    With a mesh: host mutual-reduce of the round's pivot block, then the
    one-pass batched merge with class tiles row-sharded over the mesh
    (ops/sparse_onepass — SURVEY 2.11 item 1; the old per-shard wave path
    remains as the overflow fallback).  Single device: the one-pass merge,
    falling back to the sort-based waves on tile overflow."""
    from .ops.sparse_onepass import eliminate_onepass_device

    # CPU emulation meshes pay the merge in host cycles — keep the padded
    # work budget a device-tile's worth there; real accelerators get the
    # full budget
    budget = (1 << 30) if _on_accelerator() else (1 << 27)
    Ustar, ok = mutual_reduce(f, U.to_scipy(), pcols, levels)
    if ok:
        try:
            D = eliminate_onepass_device(f, Ustar, pcols, S_rest_sp,
                                         mesh=mesh, work_budget=budget)
        except Exception as e:  # e.g. exotic mesh sharding rejections
            warnings.warn(f"[schur/device] one-pass failed "
                          f"({type(e).__name__}: {e}); wave fallback")
            D = None
        if D is not None:
            return SparseGFp.from_scipy(D, f.p, assume_canonical=True)
    log("[schur/device] one-pass unavailable; wave fallback")
    S_rest = SparseGFp.from_scipy(S_rest_sp, f.p)
    if mesh is not None:
        from .parallel.sparse_sharded import sharded_sparse_eliminate

        out = sharded_sparse_eliminate(f, mesh, U, pcols, levels, S_rest)
        if out is None:
            log("[schur/device] capacity overflow; retrying at 4x cap")
            out = sharded_sparse_eliminate(f, mesh, U, pcols, levels,
                                           S_rest, cap_factor=32)
        return out
    from .ops.sparse_device import eliminate_device

    out = eliminate_device(f, U, pcols, levels, S_rest)
    if out is None:
        log("[schur/device] capacity overflow; retrying at 4x cap")
        out = eliminate_device(f, U, pcols, levels, S_rest, cap_factor=16)
    return out


def schur_estimate_density(f: Field, U_sp, piv_cols, levels, S_rest,
                           samples: int = 100, rng=None, rest_rows=None):
    """Monte-Carlo Schur density estimate (``spasm_schur_estimate_density``,
    src/SpaSM.jl:763): eliminate a random sample of the remaining rows and
    measure the resulting fill.

    With ``rest_rows`` given, S_rest is the FULL matrix and the sample is
    drawn from its rest_rows subset (bit-identical draw: same rng stream
    over the same subset size) — the caller skips materializing the
    rest-row gather.

    The elimination of ~100 sample rows only ever touches the pivot rows
    in the reachability closure of their column support, so the pivot
    block is first restricted to that closure (a tiny fraction of a
    multi-million-row U) instead of slicing the full block per level."""
    m = S_rest.shape[1]
    q = rest_rows.size if rest_rows is not None else S_rest.shape[0]
    if q == 0 or m == 0:
        return 0.0
    if q <= samples:
        rows_sel = rest_rows  # None = all rows
    else:
        rng = np.random.default_rng(0) if rng is None else rng
        rows = np.sort(rng.choice(q, size=samples, replace=False))
        rows_sel = rest_rows[rows] if rest_rows is not None else rows
    if rows_sel is None:
        sample = S_rest
    else:
        from .native import gather_rows_native

        sample = gather_rows_native(sp.csr_matrix(S_rest), rows_sel)
        if sample is None:
            sample = S_rest[rows_sel]
    piv_cols = np.asarray(piv_cols, np.int64)
    r = U_sp.shape[0]
    # native per-row heap cascade (csrc/cascade_mod.c): exact elimination
    # against a triangular basis is unique, so the count matches the
    # closure+wave path below entry for entry
    from .native import cascade_nnz_native

    out_nnz = cascade_nnz_native(f, sp.csr_matrix(sample), U_sp, piv_cols)
    if out_nnz is not None:
        return out_nnz / max(1, sample.shape[0] * m)
    if r > 4 * samples:
        pc_of_col = np.full(m, -1, np.int64)
        pc_of_col[piv_cols] = np.arange(r)
        need = np.zeros(r, bool)
        frontier = np.unique(sample.indices)
        while frontier.size:
            k = pc_of_col[frontier]
            k = k[k >= 0]
            k = k[~need[k]]
            if k.size == 0:
                break
            need[k] = True
            lo, hi = U_sp.indptr[k], U_sp.indptr[k + 1]
            lens = hi - lo
            total = int(lens.sum())
            if total == 0:
                break
            # vectorized multi-range gather of the new rows' columns
            starts = np.repeat(np.cumsum(lens) - lens, lens)
            idx = np.repeat(lo, lens) + (np.arange(total) - starts)
            frontier = np.unique(U_sp.indices[idx])
        sel = np.flatnonzero(need)
        if sel.size < r:
            U_sp = U_sp[sel]
            piv_cols = piv_cols[sel]
            levels = levels[sel]
    out, _ = wave_eliminate(f, U_sp, piv_cols, levels, sample,
                            assume_canonical=True)
    return out.nnz / max(1, out.shape[0] * m)


# minimum seconds between dense-finish sidecar saves (tests set 0 so
# every block checkpoints; production pays at most one compressed write
# of the accumulated RREF per interval)
DENSE_CKPT_INTERVAL_S = 60.0


def _dense_finish_blocked(f: Field, S, row_origin, alive_cols, r0, opts,
                          L_parts, ckpt_path=None, dense_resume=None):
    """Blocked dense finish — the FFPACK-replacement path
    (``spasm_schur_dense`` / ``spasm_ffpack_rref`` / tall-and-skinny +
    ``spasm_schur_dense_randomized``, src/SpaSM.jl:760-812).

    The remaining rows are processed in dense row blocks against an
    accumulated dense RREF kept in **full mutual reduced form**, so
    eliminating a block is always ONE exact modular matmul, and the
    per-block rank extraction is the device Jordan RREF on a fixed
    (block x na) shape.  Memory is bounded
    by O((block + rank_tail) * na) regardless of the number of rows.

    On device, everything stays resident: blocks upload as COO, only pivot
    metadata and the final sparse U travel back.  Small problems run on
    the host (NumPy int64) outright.

    In low-rank situations, once a block stops yielding pivots a
    randomized Monte-Carlo pass (random weight-w combinations of ALL
    remaining rows) certifies the tail dependent and skips it (disabled
    when an exact L factor is requested).
    """
    n_s = S.shape[0]
    na = alive_cols.size
    bs = min(n_s, max(128, opts.dense_block_size))
    colmap = np.full(S.shape[1], -1, np.int64)
    colmap[alive_cols] = np.arange(na)
    Sc = S.tocoo()
    rows_all = Sc.row
    cols_all = colmap[Sc.col]
    vals_all = f.normalize(Sc.data)
    order = np.argsort(rows_all, kind="stable")
    rows_all, cols_all, vals_all = (rows_all[order], cols_all[order],
                                    vals_all[order])

    # validate a dense-finish sidecar against the actual finish inputs; a
    # stale file (different matrix / round / tail) is ignored
    if dense_resume is not None:
        want = dict(field_p=f.p, r0=r0, s_nnz=int(S.nnz), n_s=n_s, na=na)
        if any(dense_resume.get(k) != v for k, v in want.items()):
            log("[echelonize/dense] sidecar does not match this finish; "
                "starting from block 0")
            dense_resume = None
        else:
            log(f"[echelonize/dense] resuming at block offset "
                f"{dense_resume['b0']}")
    ckpt_meta = dict(field_p=f.p, r0=r0, s_nnz=int(S.nnz), n_s=n_s, na=na)

    device_mode = bs * na >= dense_ops.host_cutoff_for(f)
    log(f"[echelonize/dense] processing {n_s} x {na} in blocks of {bs} "
        f"({'device' if device_mode else 'host'})")
    if device_mode:
        t_dev = wtime()
        result = _blocked_device_loop(f, n_s, na, bs, rows_all, cols_all,
                                      vals_all, opts, ckpt_path=ckpt_path,
                                      resume_state=dense_resume,
                                      ckpt_meta=ckpt_meta)
        _DEVICE_FINISH_WALL[0] += wtime() - t_dev
    else:
        result = _blocked_host_loop(f, n_s, na, bs, rows_all, cols_all,
                                    vals_all, opts, ckpt_path=ckpt_path,
                                    resume_state=dense_resume,
                                    ckpt_meta=ckpt_meta)
    if ckpt_path and os.path.exists(ckpt_path):
        os.unlink(ckpt_path)  # finish completed; the sidecar is stale now
    if result is None:
        return None
    Usp_local, piv_cols_loc, piv_rows_glob = result
    r_d = piv_cols_loc.size
    log(f"[echelonize/dense] done, {r_d} pivots")
    Usp = sp.csr_matrix(Usp_local)
    Usp = sp.csr_matrix((Usp.data, alive_cols[Usp.indices], Usp.indptr),
                        shape=(r_d, S.shape[1]))
    pcols = alive_cols[piv_cols_loc]
    porig = row_origin[piv_rows_glob]
    if opts.L:
        # the dense U block is a full RREF: every S row reduces against it
        # with coefficients = its values at the pivot columns
        Csub = sp.csc_matrix(S)[:, pcols].tocoo()
        L_parts.append((row_origin[Csub.row], r0 + Csub.col, Csub.data))
    return mod_reduce(Usp, f), pcols.astype(np.int64), porig


def _block_slice(rows_all, cols_all, vals_all, b0, b1):
    lo = np.searchsorted(rows_all, b0)
    hi = np.searchsorted(rows_all, b1)
    return rows_all[lo:hi] - b0, cols_all[lo:hi], vals_all[lo:hi]


def _save_dense_ckpt(ckpt_path, ckpt_meta, b0, Uh, piv_cols_loc,
                     piv_rows_glob, dry_blocks):
    from . import checkpoint as ckpt

    ckpt.save_dense_state(ckpt_path, b0=b0, Uh=Uh,
                          piv_cols_loc=piv_cols_loc,
                          piv_rows_glob=piv_rows_glob,
                          dry_blocks=dry_blocks, **ckpt_meta)
    log(f"[echelonize/dense] checkpoint saved at block offset {b0}")


def _blocked_host_loop(f, n_s, na, bs, rows_all, cols_all, vals_all, opts,
                       ckpt_path=None, resume_state=None, ckpt_meta=None):
    from .sputil import dense_matmul_host

    Uh = np.zeros((0, na), np.int64)
    piv_cols_loc: list[int] = []
    piv_rows_glob: list[int] = []
    dry_blocks = 0
    b0 = 0
    if resume_state is not None:
        Uh = resume_state["Uh"]
        piv_cols_loc = list(resume_state["piv_cols_loc"])
        piv_rows_glob = list(resume_state["piv_rows_glob"])
        dry_blocks = resume_state["dry_blocks"]
        b0 = resume_state["b0"]
    last_save = wtime()
    while b0 < n_s:
        b1 = min(n_s, b0 + bs)
        ri, ci, vi = _block_slice(rows_all, cols_all, vals_all, b0, b1)
        X = np.zeros((b1 - b0, na), np.int64)
        X[ri, ci] = vi
        r_d = len(piv_cols_loc)
        if r_d:
            coeff = X[:, np.array(piv_cols_loc, np.int64)]
            X = f.normalize(X - dense_matmul_host(f, coeff, Uh))
        out = dense_ops.rref(f, X)
        new_rank = out["rank"]
        if new_rank:
            newU = out["R"][out["piv_rows"]].astype(np.int64)
            if r_d:
                co = Uh[:, out["piv_cols"]]
                Uh = f.normalize(Uh - dense_matmul_host(f, co, newU))
            Uh = np.vstack([Uh, newU])
            piv_cols_loc.extend(out["piv_cols"].tolist())
            piv_rows_glob.extend((b0 + out["piv_rows"]).tolist())
            dry_blocks = 0
        else:
            dry_blocks += 1
        b0 = b1
        if (ckpt_path and b0 < n_s
                and wtime() - last_save >= DENSE_CKPT_INTERVAL_S):
            _save_dense_ckpt(ckpt_path, ckpt_meta, b0, Uh, piv_cols_loc,
                             piv_rows_glob, dry_blocks)
            last_save = wtime()
        if (_low_rank_mode(opts, len(piv_cols_loc), b0, n_s)
                and dry_blocks >= 1 and not opts.L and piv_cols_loc):
            if _randomized_tail_is_dependent(
                    f, rows_all, cols_all, vals_all, b0, n_s, na, Uh,
                    np.array(piv_cols_loc, np.int64), opts):
                log(f"[echelonize/dense] randomized check: remaining "
                    f"{n_s - b0} rows dependent; skipping")
                break
    if not piv_cols_loc:
        return None
    return (sp.csr_matrix(Uh), np.array(piv_cols_loc, np.int64),
            np.array(piv_rows_glob, np.int64))


def _low_rank_mode(opts, rank_so_far, rows_processed, n_s):
    """The randomized tail shortcut engages only in genuinely low-rank
    situations (``low_rank_ratio``, src/SpaSM.jl:341): the rank harvested
    so far must be below low_rank_ratio * rows processed, and low-rank
    mode (enable_tall_and_skinny, --no-low-rank-mode) must be on."""
    if not opts.enable_tall_and_skinny or rows_processed >= n_s:
        return False
    return rank_so_far < opts.low_rank_ratio * max(1, rows_processed)


def _blocked_device_loop(f, n_s, na, bs, rows_all, cols_all, vals_all,
                         opts, ckpt_path=None, resume_state=None,
                         ckpt_meta=None):
    """Device-resident block loop: ONE fused jitted step per block
    (dense_ops.blocked_finish_step), U capacity preallocated to the rank
    upper bound so every block reuses the same compiled program."""
    import jax.numpy as jnp

    bs_b = dense_ops._bucket(bs)
    na_b = dense_ops._bucket(na)
    # low-rank mode == tall-and-skinny mode in the reference; only there
    # does the loop need per-block rank readbacks (to detect a dry tail),
    # which rules out the single-dispatch fused finish below.
    low_rank_possible = (opts.enable_tall_and_skinny and not opts.L
                         and n_s > opts.tall_and_skinny_ratio * na)
    n_pad = -(-n_s // bs_b) * bs_b
    if (not low_rank_possible and resume_state is None
            and n_pad * na_b <= dense_ops.FUSED_BUDGET):
        return _fused_device_finish(f, n_s, na, na_b, bs_b, rows_all,
                                    cols_all, vals_all)
    # rank can never exceed min(rows, cols); preallocate once
    cap = dense_ops._bucket(min(n_s, na)) + bs_b
    Ud = jnp.zeros((cap, na_b), jnp.int32)
    pc_map = jnp.zeros(cap, jnp.int32)
    r_d_dev = jnp.int32(0)
    piv_cols_loc: list[int] = []
    piv_rows_glob: list[int] = []
    dry_blocks = 0
    b0_start = 0
    if resume_state is not None:
        piv_cols_loc = list(resume_state["piv_cols_loc"])
        piv_rows_glob = list(resume_state["piv_rows_glob"])
        dry_blocks = resume_state["dry_blocks"]
        b0_start = resume_state["b0"]
        r_res = len(piv_cols_loc)
        if r_res:
            Uh0 = np.zeros((r_res, na_b), np.int32)
            Uh0[:, :na] = resume_state["Uh"]
            Ud = Ud.at[:r_res].set(jnp.asarray(Uh0))
            pc_map = pc_map.at[:r_res].set(
                jnp.asarray(np.asarray(piv_cols_loc, np.int32)))
            r_d_dev = jnp.int32(r_res)

    def _extract_uh_host():
        """Pull the accumulated RREF back as a host (r_d, na) dense block
        (sidecar payload)."""
        nnz_d = dense_ops.count_nonzero_device(Ud)
        ecap = max(128, 1 << int(max(1, nnz_d - 1)).bit_length())
        er, ec, ev = (np.asarray(x)
                      for x in dense_ops.extract_sparse(Ud, ecap))
        keep = (er >= 0) & (ec < na)
        Uh = np.zeros((len(piv_cols_loc), na), np.int64)
        Uh[er[keep], ec[keep]] = ev[keep]
        return Uh
    # small device->host syncs are latency-bound: pipeline with one block
    # of lag, reading block k-1's pivot
    # metadata while block k computes
    pending = None  # (b0, rank_d, prow_of, pcol_of)

    def _drain(pending):
        nonlocal dry_blocks
        if pending is None:
            return False
        pb0, rank_d, prow_of, pcol_of = pending
        new_rank = int(rank_d)
        if new_rank:
            prow = np.asarray(prow_of)[:new_rank].astype(np.int64)
            pcol = np.asarray(pcol_of)[:new_rank].astype(np.int64)
            piv_cols_loc.extend(pcol.tolist())
            piv_rows_glob.extend((pb0 + prow).tolist())
            dry_blocks = 0
        else:
            dry_blocks += 1
        return new_rank == 0

    # In low-rank mode the loop reads back each block's rank; otherwise
    # ALL metadata reads are deferred past the loop (sync-free pipeline).
    deferred = []
    last_save = wtime()
    b0 = b0_start
    while b0 < n_s:
        b1 = min(n_s, b0 + bs)
        ri, ci, vi = _block_slice(rows_all, cols_all, vals_all, b0, b1)
        # bucket the nnz shape: distinct shapes recompile the whole fused
        # step; zero padding scatters
        # +0 at (0, 0) which blocked_finish_step's .add ignores
        ncap = max(512, 1 << int(max(1, ri.size - 1)).bit_length())
        ri = np.pad(ri.astype(np.int32), (0, ncap - ri.size))
        ci = np.pad(ci.astype(np.int32), (0, ncap - ci.size))
        vi = np.pad(vi.astype(np.int32), (0, ncap - vi.size))
        Ud, pc_map, r_d_dev, rank_d, prow_of, pcol_of = (
            dense_ops.blocked_finish_step(
                f, (bs_b, na_b), dense_ops.DEFAULT_PANEL,
                jnp.asarray(ri), jnp.asarray(ci), jnp.asarray(vi),
                Ud, pc_map, r_d_dev))
        for arr in (rank_d, prow_of, pcol_of):
            try:
                arr.copy_to_host_async()
            except AttributeError:  # pragma: no cover - non-jax backends
                pass
        ckpt_due = (ckpt_path and b1 < n_s
                    and wtime() - last_save >= DENSE_CKPT_INTERVAL_S)
        if not low_rank_possible:
            deferred.append((b0, rank_d, prow_of, pcol_of))
            b0 = b1
            if ckpt_due:
                # sidecar save syncs the deferred metadata reads once,
                # then pulls the accumulated RREF — amortized by the save
                # interval, the steady-state pipeline stays sync-free
                for item in deferred:
                    _drain(item)
                deferred.clear()
                _save_dense_ckpt(ckpt_path, ckpt_meta, b0,
                                 _extract_uh_host(), piv_cols_loc,
                                 piv_rows_glob, dry_blocks)
                last_save = wtime()
            continue
        _drain(pending)
        pending = (b0, rank_d, prow_of, pcol_of)
        b0 = b1
        if ckpt_due:
            _drain(pending)
            pending = None
            _save_dense_ckpt(ckpt_path, ckpt_meta, b0, _extract_uh_host(),
                             piv_cols_loc, piv_rows_glob, dry_blocks)
            last_save = wtime()
        if (dry_blocks >= 1 and piv_cols_loc
                and _low_rank_mode(opts, len(piv_cols_loc), b0, n_s)):
            _drain(pending)
            pending = None
            nnz_d = dense_ops.count_nonzero_device(Ud)
            ecap = max(128, 1 << int(max(1, nnz_d - 1)).bit_length())
            er, ec, ev = (np.asarray(x)
                          for x in dense_ops.extract_sparse(Ud, ecap))
            keep = er >= 0
            Uh = np.zeros((len(piv_cols_loc), na), np.int64)
            Uh[er[keep], ec[keep]] = ev[keep]
            if _randomized_tail_is_dependent(
                    f, rows_all, cols_all, vals_all, b0, n_s, na, Uh,
                    np.array(piv_cols_loc, np.int64), opts):
                log(f"[echelonize/dense] randomized check: remaining "
                    f"{n_s - b0} rows dependent; skipping")
                break
    _drain(pending)
    for item in deferred:
        _drain(item)
    r_d = len(piv_cols_loc)
    if r_d == 0:
        return None
    Usp = dense_ops.extract_u_csr(Ud, pc_map, r_d, na, piv_cols_loc)
    return (Usp, np.array(piv_cols_loc, np.int64),
            np.array(piv_rows_glob, np.int64))


def _fused_device_finish(f, n_s, na, na_b, bs, rows_all, cols_all,
                         vals_all):
    """Single-dispatch dense finish: the entire block loop runs inside one
    jitted ``dense_ops.fused_blocked_finish`` call (device-resident
    ``lax.while_loop``), then exactly two readbacks — per-block pivot
    metadata, and the sparse extraction of the accumulated U.  Removes the
    per-block dispatch and sync latency of the streaming loop (which remains
    for the low-rank / over-budget cases)."""
    import jax.numpy as jnp

    n_pad = -(-n_s // bs) * bs
    nnz = rows_all.size
    ncap = max(512, 1 << int(max(1, nnz - 1)).bit_length())
    ri = np.pad(rows_all.astype(np.int32), (0, ncap - nnz))
    ci = np.pad(cols_all.astype(np.int32), (0, ncap - nnz))
    vi = np.pad(vals_all.astype(np.int32), (0, ncap - nnz))
    Ud, pc_map, r_d_dev, ranks, prows, pcols = (
        dense_ops.fused_blocked_finish(
            f, (n_pad, na_b), na, bs, dense_ops.DEFAULT_PANEL,
            jnp.asarray(ri), jnp.asarray(ci), jnp.asarray(vi)))
    for arr in (ranks, prows, pcols):
        try:
            arr.copy_to_host_async()
        except AttributeError:  # pragma: no cover - non-jax backends
            pass
    ranks = np.asarray(ranks)
    prows = np.asarray(prows)
    pcols = np.asarray(pcols)
    piv_cols_loc: list[int] = []
    piv_rows_glob: list[int] = []
    for b in np.flatnonzero(ranks):
        k = int(ranks[b])
        piv_cols_loc.extend(pcols[b, :k].tolist())
        piv_rows_glob.extend((b * bs + prows[b, :k]).tolist())
    r_d = len(piv_cols_loc)
    if r_d == 0:
        return None
    Usp = dense_ops.extract_u_csr(Ud, pc_map, r_d, na, piv_cols_loc)
    return (Usp, np.array(piv_cols_loc, np.int64),
            np.array(piv_rows_glob, np.int64))


def _randomized_tail_is_dependent(f, rows_all, cols_all, vals_all, b0, n_s,
                                  na, Uh, piv_cols_loc, opts,
                                  samples: int = 8):
    """spasm_schur_dense_randomized-style check: N random weight-w
    combinations of the unprocessed rows; dependent (whp) iff all reduce to
    zero against the dense RREF."""
    from .sputil import dense_matmul_host

    rng = np.random.default_rng(12345)
    w = int(opts.low_rank_start_weight)
    if w <= 0:
        w = 16
    tail_rows = np.arange(b0, n_s)
    w = min(w, tail_rows.size)
    X = np.zeros((samples, na), np.int64)
    mask_tail = (rows_all >= b0)
    rt, ct, vt = (rows_all[mask_tail], cols_all[mask_tail],
                  vals_all[mask_tail])
    order = np.argsort(rt, kind="stable")
    rt, ct, vt = rt[order], ct[order], vt[order]
    starts = np.searchsorted(rt, tail_rows)
    ends = np.searchsorted(rt, tail_rows + 1)
    for s in range(samples):
        picks = rng.choice(tail_rows.size, size=w, replace=False)
        for t in picks:
            coef = int(f.rand(1, rng)[0]) or 1
            sl = slice(starts[t], ends[t])
            X[s, ct[sl]] = f.normalize(X[s, ct[sl]] + coef * vt[sl])
    X = f.normalize(X)
    res = f.normalize(X - dense_matmul_host(f, X[:, piv_cols_loc], Uh))
    return not bool(res.any())


def _gplu_finish(f: Field, S, row_origin, r0, opts, L_parts):
    """Sparse left-looking finish — the GPLU role (src/SpaSM.jl:815,
    README.md:34-36 '[echelonize/GPLU]'), reformulated batch-wise.

    Left-looking GPLU processes one row at a time against the pivots found
    so far.  Batched equivalent: iterate structural-pivot rounds with no
    stopping threshold — FL always yields at least one pivot per nonzero
    matrix, every round's pivot set is cycle-free, and the global order
    keeps the append invariant, so this terminates with the same rank/row
    space and stays fully vectorized (scipy waves) instead of a per-row
    Python scatter loop."""
    n_s, m = S.shape
    log(f"[echelonize/GPLU] processing matrix of dimension {n_s} x {m}")
    S = mod_reduce(S, f)
    U_blocks = []
    piv_cols_all = []
    piv_orig_all = []
    r_local = 0
    # Each round harvests a maximal FL + greedy cycle-free set; the
    # fractional-insertion greedy resolves cascade/chain tails within a
    # round (see tests/test_echelonize.py::test_adversarial_cascade_tail),
    # so the loop normally runs O(DAG-depth) rounds.  ADVERSARIAL
    # structures DO exist where every strategy degrades to ~1 pivot/round
    # — a dense (or dense-cored) residue has every pair of rows
    # interacting, so no two pivots are ever mutually insertable
    # (tests/test_echelonize.py::test_gplu_adversarial_dense_block) —
    # making the batched loop Theta(n) rounds of full-matrix sweeps.  The
    # lean-round detector below hands such residues to the per-row
    # left-looking elimination (_gplu_sequential, the reference's actual
    # GPLU, src/SpaSM.jl:694-722), which finishes them in ONE pass.
    round_cap = 64 + 2 * (min(n_s, m) // 4096 + 1)
    rounds_done = 0
    lean_rounds = 0
    while S.shape[0] and S.nnz:
        rounds_done += 1
        Sw = SparseGFp.from_scipy(S, f.p, assume_canonical=True)
        prows, pcols, _ = find_structural_pivots(Sw, enable_greedy=True)
        assert prows.size > 0, "FL must find a pivot in a nonzero matrix"
        npiv = prows.size
        active = int((np.diff(S.indptr) > 0).sum())
        lean_rounds = lean_rounds + 1 if npiv * 16 < active else 0
        if lean_rounds >= 3 or rounds_done >= round_cap:
            log(f"[echelonize/GPLU] batched rounds degraded "
                f"({npiv} pivots / {active} active rows); switching to "
                "per-row left-looking elimination")
            seq = _gplu_sequential(f, S, row_origin, r0 + r_local, opts,
                                   L_parts)
            if seq is not None:
                Useq, pcols_seq, porig_seq = seq
                U_blocks.append(Useq)
                piv_cols_all.append(pcols_seq)
                piv_orig_all.append(porig_seq)
                r_local += pcols_seq.size
            S = sp.csr_matrix((0, m), dtype=S.dtype)
            break
        Upart = sp.csr_matrix(S[prows])
        piv_vals = np.asarray(
            Upart[np.arange(npiv), pcols]).ravel().astype(np.int64)
        scales = f.inv(piv_vals)
        row_of = np.repeat(np.arange(npiv), np.diff(Upart.indptr))
        Upart.data = f.normalize(Upart.data * scales[row_of])
        levels_blk = compute_levels(
            SparseGFp.from_scipy(Upart, f.p, assume_canonical=True), pcols)
        rest_mask = np.ones(S.shape[0], bool)
        rest_mask[prows] = False
        rest_rows = np.flatnonzero(rest_mask)
        ok = False
        if not opts.L:
            Ustar, ok = mutual_reduce(f, Upart, pcols, levels_blk)
        if ok:
            S_new, C = eliminate_against_reduced(
                f, Ustar, pcols, S[rest_rows], assume_canonical=True)
            Upart = Ustar
        else:
            S_new, C = wave_eliminate(f, Upart, pcols, levels_blk,
                                      S[rest_rows], record_coeffs=opts.L,
                                      assume_canonical=True)
        if opts.L:
            L_parts.append((row_origin[prows],
                            r0 + r_local + np.arange(npiv), piv_vals))
            Cc = C.tocoo()
            L_parts.append((row_origin[rest_rows][Cc.row],
                            r0 + r_local + Cc.col, Cc.data))
        U_blocks.append(Upart)
        piv_cols_all.append(pcols.astype(np.int64))
        piv_orig_all.append(row_origin[prows])
        r_local += npiv
        S = S_new
        row_origin = row_origin[rest_rows]
    if r_local == 0:
        log("[echelonize/GPLU] empty tail")
        return None
    log("[echelonize/GPLU] full rank reached" if r_local == n_s
        else f"[echelonize/GPLU] rank {r_local}")
    Usp = sp.vstack(U_blocks, format="csr")
    return (mod_reduce(Usp, f), np.concatenate(piv_cols_all),
            np.concatenate(piv_orig_all))


def _gplu_sequential(f: Field, S, row_origin, r0, opts, L_parts):
    """Per-row left-looking sparse elimination — the reference's actual
    GPLU algorithm (spasm_sparse_triangular_solve driven per row,
    src/SpaSM.jl:694-722,815).  Fallback for residues where the batched
    structural rounds degrade (heavily overlapping supports: each round
    finds O(1) pivots, so the round loop would be Theta(n) full sweeps).

    Processes rows in order; each row is eliminated against the pivots
    found so far in increasing pivot-index order via a min-heap worklist
    (valid because pivot row k can only hit columns of pivots selected
    AFTER k — the append invariant).  A nonzero residual contributes a
    new unit pivot at its leftmost column.  Returns (U csr, pcols, porig)
    or None for a zero tail; L coefficients appended when opts.L.

    The hot path is the C port (csrc/gplu_mod.c, bit-identical; a 10k-row
    dense-cored residue finishes in ~1 s vs minutes of Python heap loop);
    the Python loop below is the fallback.
    """
    import heapq

    n_s, m = S.shape
    from .native import gplu_native

    out = gplu_native(f, S, bool(opts.L))
    if out is not None:
        indptr, indices, data, pcol, prow, ltrip = out
        r_new = pcol.size
        log(f"[echelonize/GPLU] sequential pass: {r_new} pivots from "
            f"{n_s} rows")
        if opts.L and ltrip is not None:
            li, lk, lv = ltrip
            L_parts.append((row_origin[li], r0 + lk, lv))
        if r_new == 0:
            return None
        Usp = sp.csr_matrix((data, indices, indptr), shape=(r_new, m))
        Usp.has_sorted_indices = True
        return Usp, pcol, row_origin[prow]
    indptr, indices, data = S.indptr, S.indices, S.data
    x = np.zeros(m, np.int64)
    piv_col = []                  # pivot column of pivot k
    u_cols: list = []             # unit-scaled pivot row supports
    u_vals: list = []
    porig = []
    qinv = np.full(m, -1, np.int64)
    for i in range(n_s):
        ji = indices[indptr[i]:indptr[i + 1]].astype(np.int64)
        if ji.size == 0:
            continue
        x[ji] = data[indptr[i]:indptr[i + 1]]
        touched = [ji]
        inq = np.zeros(max(1, len(piv_col)), bool)
        heap = [int(k) for k in qinv[ji] if k >= 0]
        inq[heap] = True
        heapq.heapify(heap)
        coefs_k, coefs_v = [], []
        while heap:
            k = heapq.heappop(heap)
            c = x[piv_col[k]]
            if c == 0:
                continue
            uc, uv = u_cols[k], u_vals[k]
            x[uc] = f.normalize(x[uc] - c * uv)
            touched.append(uc)
            if opts.L:
                coefs_k.append(k)
                coefs_v.append(c)
            hits = qinv[uc]
            for k2 in hits[(hits > k) & ~inq[np.clip(hits, 0, inq.size - 1)]]:
                inq[k2] = True           # only later pivots can appear
                heapq.heappush(heap, int(k2))
        cols_t = np.unique(np.concatenate(touched))
        vals_t = x[cols_t]
        nz = vals_t != 0
        cols_nz, vals_nz = cols_t[nz], vals_t[nz]
        if opts.L and coefs_k:
            L_parts.append((np.full(len(coefs_k), row_origin[i]),
                            r0 + np.array(coefs_k, np.int64),
                            np.array(coefs_v, np.int64)))
        if cols_nz.size:
            j = cols_nz[0]               # leftmost residual column
            v = vals_nz[np.searchsorted(cols_nz, j)]
            k_new = len(piv_col)
            qinv[j] = k_new
            piv_col.append(int(j))
            u_cols.append(cols_nz)
            u_vals.append(f.normalize(vals_nz * int(f.inv(
                np.array([v], np.int64))[0])))
            porig.append(row_origin[i])
            if opts.L:
                L_parts.append((np.array([row_origin[i]]),
                                np.array([r0 + k_new], np.int64),
                                np.array([v], np.int64)))
        x[cols_t] = 0
    r_new = len(piv_col)
    log(f"[echelonize/GPLU] sequential pass: {r_new} pivots from "
        f"{n_s} rows")
    if r_new == 0:
        return None
    lens = np.array([c.size for c in u_cols], np.int64)
    Usp = sp.csr_matrix(
        (np.concatenate(u_vals), np.concatenate(u_cols),
         np.concatenate([[0], np.cumsum(lens)])), shape=(r_new, m))
    return (Usp, np.array(piv_col, np.int64), np.array(porig, np.int64))
