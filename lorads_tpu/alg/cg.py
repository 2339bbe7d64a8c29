"""Batched matrix-free conjugate gradients over [B, n, r] unknowns.

One CG instance per block, all blocks of a bucket advanced in lockstep
with per-block convergence masking (a converged block's iterates stop
changing; its alpha/beta are forced to 0).  Semantics mirror the
reference CGSolve (/root/reference/src_semi/linalg/lorads_cgs.c:81-240):

* stop when ||r||_2 / ||b||_1 < tol   (note the 1-norm scale)
* true-residual restart every 20 iterations
* warm start from the incoming x
* alpha = <r,r>/<p,Ap>, beta = <r',r'>/<r,r>

The operator is supplied as a closure X -> A(X) acting on [B, n, r].
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

RESTART_FREQ = 20


def _bdot(x, y):
    """Per-block dot: [B, n, r] x [B, n, r] -> [B]."""
    return jnp.sum(x * y, axis=(1, 2))


def cg_solve(op: Callable[[jnp.ndarray], jnp.ndarray], x0: jnp.ndarray,
             b: jnp.ndarray, tol, max_iter) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Solve op(x) = b for each block.  Returns (x, iters_per_block)."""
    b_nrm1 = jnp.sum(jnp.abs(b), axis=(1, 2))          # [B]
    safe_b1 = jnp.where(b_nrm1 == 0, 1.0, b_nrm1)

    r0 = b - op(x0)
    res0 = jnp.sqrt(_bdot(r0, r0))
    done0 = res0 / safe_b1 < tol

    def cond(c):
        done, k = c[4], c[5]
        return (~jnp.all(done)) & (k < max_iter)

    def body(c):
        x, r, p, res, done, k = c[:6]
        Q = op(p)
        qtr = _bdot(r, r)
        ptq = _bdot(p, Q)
        active = (~done).astype(x.dtype)
        alpha = jnp.where(ptq != 0, qtr / jnp.where(ptq == 0, 1.0, ptq),
                          0.0) * active
        x = x + alpha[:, None, None] * p
        r = r - alpha[:, None, None] * Q

        # true-residual restart (lorads_cgs.c:195-211)
        def restart(args):
            x_, r_ = args
            return b - op(x_)
        r = jax.lax.cond(k % RESTART_FREQ == 0, restart,
                         lambda args: args[1], (x, r))

        qtr_new = _bdot(r, r)
        res_new = jnp.sqrt(qtr_new)
        nan_mask = jnp.isnan(res_new)
        done_new = done | (res_new / safe_b1 < tol) | nan_mask
        # No-progress stop (extension; the reference CG has only the
        # tol/maxiter exits).  A tol below the arithmetic noise floor
        # (f32 with a tiny pinf-scaled tol) otherwise burns the full
        # 800-iteration cap per solve at NO iterate improvement —
        # 71k CG iters per 87 ADMM iters on matcomp2000.  A block
        # whose residual hasn't improved 1% in 40 iterations (two
        # true-residual restarts) has hit ITS floor; stop it there —
        # this keeps whatever depth IS reachable, unlike a fixed
        # tol floor.
        best, since = c[6], c[7]
        improved = res_new < 0.99 * best
        best = jnp.minimum(best, res_new)
        since = jnp.where(improved | done_new, 0, since + 1)
        done_new = done_new | (since >= 40)
        beta = jnp.where(qtr != 0, qtr_new / jnp.where(qtr == 0, 1.0, qtr),
                         0.0) * active
        p = r + beta[:, None, None] * p
        return (x, r, p, res_new, done_new, k + 1, best, since)

    carry = (x0, r0, r0, res0, done0, jnp.zeros((), jnp.int32),
             res0, jnp.zeros_like(res0, dtype=jnp.int32))
    out = jax.lax.while_loop(cond, body, carry)
    x, k = out[0], out[5]
    return x, k


def cg_solve_ir(op_hi: Callable[[jnp.ndarray], jnp.ndarray],
                op_lo: Callable[[jnp.ndarray], jnp.ndarray],
                x0: jnp.ndarray, b: jnp.ndarray, tol, max_iter,
                inner_tol: float = 1e-5,
                max_passes: int = 6) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mixed-precision CG by iterative refinement: inner CG sweeps at
    low precision (op_lo, float32) with true residuals accumulated at
    high precision (op_hi, the ambient float64 operator).

    Each refinement pass solves op_lo(d) ~= r for the current f64
    residual r (relative reduction ``inner_tol``, bounded by the inner
    CG's own no-progress stop), applies x += d, and recomputes
    r = b - op_hi(x) exactly.  The stopping rule is the reference's
    ||r||_2 / ||b||_1 < tol on the TRUE f64 residual — identical
    accuracy semantics to an all-f64 solve, at one f64 matvec per pass
    instead of one per CG iteration (DESIGN.md #19c).  Standard IR
    convergence applies:
    the residual contracts per pass until kappa(N) * eps_f32 ~ 1, where
    an all-f64 CG also stops progressing in comparable budgets; a pass
    that fails to halve the residual marks the block done at its floor
    (mirrors cg_solve's no-progress stop).

    Reference semantics target: CGSolve (lorads_cgs.c:81-240) run at
    native f64.  Returns (x, total inner iterations).
    """
    b_nrm1 = jnp.sum(jnp.abs(b), axis=(1, 2))
    safe_b1 = jnp.where(b_nrm1 == 0, 1.0, b_nrm1)

    r0 = b - op_hi(x0)
    res0 = jnp.sqrt(_bdot(r0, r0))
    done0 = (res0 / safe_b1 < tol) | jnp.isnan(res0)

    def cond(c):
        done, passes = c[3], c[4]
        return (~jnp.all(done)) & (passes < max_passes)

    def body(c):
        x, r, res, done, passes, total = c
        # inner f32 solve of op_lo(d) = r from zero: cg_solve's exit is
        # ||res|| / ||r||_1 < inner_tol (a RELATIVE reduction because r
        # is the inner b), with its no-progress stop bounding work when
        # the f32 floor is above inner_tol
        d32, k = cg_solve(op_lo, jnp.zeros_like(r, jnp.float32),
                          r.astype(jnp.float32), inner_tol, max_iter)
        act = (~done).astype(x.dtype)[:, None, None]
        x_new = x + act * d32.astype(x.dtype)
        r_new = b - op_hi(x_new)
        res_new = jnp.sqrt(_bdot(r_new, r_new))
        nan = jnp.isnan(res_new)
        # A pass that WORSENED the residual (f32 cast overflow at large
        # rho, inner-CG breakdown) must not replace the warm start —
        # revert that block to its best iterate before stopping it.
        keep = ((res_new <= res) & ~nan)[:, None, None]
        x_new = jnp.where(keep, x_new, x)
        r_new = jnp.where(keep, r_new, r)
        res_kept = jnp.where(keep[:, 0, 0], res_new, res)
        # a pass that failed to halve the residual has hit the IR
        # contraction floor for that block — stop refining it
        done_new = done | (res_kept / safe_b1 < tol) | nan \
            | (res_new > 0.5 * res)
        return (x_new, r_new, res_kept, done_new, passes + 1, total + k)

    carry = (x0, r0, res0, done0, jnp.zeros((), jnp.int32),
             jnp.zeros((), jnp.int32))
    x, _, _, _, _, total = jax.lax.while_loop(cond, body, carry)
    return x, total
