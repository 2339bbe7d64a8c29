"""lorads_tpu — a low-rank SDP solver on JAX/XLA.

A from-scratch rebuild of the capabilities of LoRADS (COPT-Public/LoRADS):
a two-phase first-order solver for standard-form semidefinite programs

    min <C, X>  s.t.  A(X) = b,  X >= 0 (PSD),

optionally with one LP (nonnegative-orthant) block.  X is never formed:
it is factored X = R R^T (Burer-Monteiro) with rank r = O(log n).

Phase I  (ALM):  L-BFGS with an exact quartic line search on the
                 augmented Lagrangian in R.
Phase II (ADMM): splitting X = U V^T, alternating U/V updates, each a
                 matrix-free CG solve, plus dual ascent.

The compute path is plain JAX (jit / vmap / lax loops) compiled by XLA
for the accelerator (an NVIDIA GPU; the CPU for tests): constraint
applications A(UV^T) are batched gathers and segment sums on a
per-block union sparsity pattern, factor updates are dense matrix
products, and multi-block problems shard over a `jax.sharding.Mesh`.

Reference parity: docstrings cite /root/reference/src_semi/<file>:<line>.
"""

import os as _os

import jax as _jax

# The algorithms (exact line search, ill-conditioned CG at rho up to
# 1e6, DIMACS at 1e-7) need f64 accumulation; the f32 path is the
# dtype="auto" start on accelerators (see LoradsParams.dtype).
_jax.config.update("jax_enable_x64", True)

# Every dot here is DIMACS-critical (line-search coefficients, L-BFGS
# curvature, CG reductions).  XLA's default f32 matmul precision on a
# GPU is TF32, which keeps ~1e-3 relative accuracy and stalls the line
# search and CG; force full-precision products globally.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: solver graphs are large (whole ALM /
# ADMM loops), so caching across processes removes most of a cold
# start.  JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and
# is left alone; otherwise the cache lives at a fixed directory inside
# the checkout (listed in .gitignore).  LORADS_TPU_NO_COMPILE_CACHE=1
# turns the cache off (the test suite does).
if _os.environ.get("LORADS_TPU_NO_COMPILE_CACHE"):
    _jax.config.update("jax_enable_compilation_cache", False)
elif not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))

from lorads_tpu.config import LoradsParams, SolverStatus
from lorads_tpu.core.problem import (SDPProblem, merge_problems,
                                     split_objectives)
from lorads_tpu.io.sdpa import read_sdpa, write_sdpa
from lorads_tpu.alg.solver import LoradsSolver, solve

__version__ = "0.1.0"

__all__ = [
    "LoradsParams",
    "SolverStatus",
    "SDPProblem",
    "merge_problems",
    "split_objectives",
    "read_sdpa",
    "write_sdpa",
    "LoradsSolver",
    "solve",
]
