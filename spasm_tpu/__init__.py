"""spasm_tpu — sparse exact linear algebra over GF(p) on an accelerator.

A from-scratch re-design of the capabilities of SpaSM / SpaSM.jl (sparse
direct solver mod p) in JAX: XLA device kernels, host NumPy and OpenMP
orchestration, jax.sharding multi-device scale-out.  See
SURVEY.md for the reference feature map this implements.

Memory note: the native Schur/elimination kernels keep per-worker sparse
accumulators sized to the largest column count ever processed (~24 bytes x
m per thread) for the life of the process — the same high-water-mark policy
as the tuned allocator.  Long-lived embedders can reclaim that scratch
after a one-off huge problem with :func:`release_native_scratch`.
"""

import os as _os

import jax as _jax

# dense elimination kernels compile once per shape bucket; a persistent
# cache makes that a one-time cost per checkout.  JAX_COMPILATION_CACHE_DIR
# (or a cache directory configured before import) takes precedence; the
# default is one fixed directory inside the checkout (listed in .gitignore).
_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if (not _os.environ.get("JAX_COMPILATION_CACHE_DIR")
        and _jax.config.jax_compilation_cache_dir is None):
    _jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .field import DEFAULT_PRIME, F0, Field, ZZp, field
from .csr import (SparseGFp, Triplet, inverse_permutation, ipvec, pvec,
                  random_permutation)
from .io import dumps_sms, load_sms, matrix_hash, save_pnm, save_sms
from .echelonize import LU, EchelonizeOptions, echelonize
from .solve import (dense_back_solve, dense_forward_solve, gesv, kernel,
                    kernel_from_rref, kernel_pivots, rank, rref, rref_of_U,
                    solve, sparse_triangular_solve)
from .graphs import (dulmage_mendelsohn, maximum_matching,
                     strongly_connected_components, structural_rank)
from .blocks import (Block, block_decompose, echelonize_blocks,
                     kernel_blocks, rank_blocks)
from .certificate import (RankCertificate, certificate_rank_create,
                          certificate_rank_verify, factorization_verify,
                          rank_certificate_load, rank_certificate_save)
from .checkpoint import load_lu, save_lu
from .native import release_native_scratch
from .utils.logging import set_log, wtime

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_PRIME", "F0", "Field", "field",
    "SparseGFp", "Triplet", "inverse_permutation", "ipvec", "pvec",
    "random_permutation",
    "dumps_sms", "load_sms", "matrix_hash", "save_pnm", "save_sms",
    "LU", "EchelonizeOptions", "echelonize",
    "dense_back_solve", "dense_forward_solve", "gesv", "kernel",
    "kernel_from_rref", "kernel_pivots", "rank", "rref", "rref_of_U",
    "solve", "sparse_triangular_solve",
    "release_native_scratch",
    "set_log", "wtime",
]
