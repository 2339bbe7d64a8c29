"""Direct dual refinement: factor-space least squares on the slack.

At a primal-dual optimum of min <C,X> s.t. A(X)=b, X >= 0 with
X = R R^T, complementary slackness forces S(lambda) R = 0 where
S(lambda) = C - A^*(lambda) is the dual slack.  Given a near-optimal
primal factor R, the dual consistent with complementarity solves the
LINEAR least-squares problem

    min_lambda  || (C - A^*(lambda)) R ||_F^2            (LS)

The reference reaches the same stationarity (2 S R = 0 is exactly the
ALM gradient at the implied multiplier) by re-grinding a high-rho ALM
on R through reopt rounds (lorads_solver.c:1075-1117, main.c:414-476)
— gradient descent in R at f64.  Solving (LS)
directly in lambda is a handful of CGNR iterations on operators the
solver already has:

    M d    = A^*(d) R          (one adjoint-apply + factor product,
                                = aop.grad/2 minus the C term)
    M^T Y  = A(sym(Y R^T))     (= aop.auv against R)

so each CGNR iteration costs about one ALM inner iteration, and the
whole refinement is one device dispatch.  The refined lambda moves
dObj = b^T lambda; the caller re-measures dinf/gap at the candidate
and accepts only if the DIMACS outcome improves (alg/solver.py).

No reference counterpart (deviation, docs/DESIGN.md #20); the
reference's only dual-restoration mechanism is the reopt grind this
replaces when it succeeds.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lorads_tpu.alg import aop
from lorads_tpu.alg.state import FactorVec


def _half(fv):
    return jax.tree.map(lambda a: 0.5 * a, fv)


def _weight_by_spectrum(R):
    """Rt = R (R^T R)^{1/2} per cone, so that ||S Rt||_F =
    ||S R R^T||_F = ||S X||_F: the LS equations weighted by X's
    spectrum.  Unweighted ||S R||_F treats R's noise-level columns
    (rank caps force r well above X's numerical rank) equally with
    its dominant ones, which props the LS floor far above what
    complementarity actually requires — measured on theta n=150:
    unweighted CGNR exactly converged yet moved ||S R|| only 5%.
    The r x r Gram square roots are trivial (eigh at r <= ~60)."""
    cones = []
    for Rb in R.cones:
        G = jnp.einsum("bnr,bns->brs", Rb, Rb, precision="highest")
        evals, evecs = jnp.linalg.eigh(G)
        sq = jnp.sqrt(jnp.maximum(evals, 0.0))
        Gh = jnp.einsum("brk,bk,bsk->brs", evecs, sq, evecs,
                        precision="highest")
        cones.append(jnp.einsum("bnr,brs->bns", Rb, Gh,
                                precision="highest"))
    return FactorVec(tuple(cones), R.lp)


def _sub(a, b):
    return jax.tree.map(lambda x, y: x - y, a, b)


def _fv_norm2(fv):
    leaves = jax.tree.leaves(fv)
    return sum(jnp.sum(x * x) for x in leaves)


@partial(jax.jit, static_argnames=("n_iter",))
def dual_ls_refine(pd, R, dual, n_iter: int, rel_tol=1e-4):
    """CGNR for (LS) from the current dual, restricted to the
    dual-objective level set {d : b^T d = 0}.

    Solves the normal equations (M^T M) d = M^T r0 with
    r0 = S(dual) R over the b-orthogonal subspace, then returns
    (step d, ls_norm0, ls_norm1): the refinement DIRECTION and the LS
    objective sqrt before/after (device scalars, for logging/accept
    decisions).  The caller forms candidates dual + t d.

    The b-orthogonality is load-bearing: dObj = b^T lambda is exactly
    unchanged by any step in the subspace, so the refinement can only
    improve (or leave) the gap — never trade it away.  Measured
    without it (theta n=300): the unconstrained LS minimizer reached
    dinf 0 at a dObj 70 below pObj (gap 0.19) because ||S R||_F only
    controls S on R's column space and the minimum-norm step still
    walked the free b-component — the candidate was useless despite
    exact complementarity.

    Runs at the ambient dtype; the caller re-certifies every
    candidate with the standard Lanczos/eigh certificate, so CGNR
    accuracy only bounds how much dinf improvement is available,
    never correctness.
    """
    R = _weight_by_spectrum(R)
    zero_w = jnp.zeros_like(dual)
    CR = _half(aop.grad(pd, R, zero_w))          # C R

    def M(d):                                    # A^*(d) R
        return _sub(_half(aop.grad(pd, R, d)), CR)

    def Mt(Y):                                   # A(sym(Y R^T)) in R^m
        return aop.auv(pd, Y, R)[1]

    bb = jnp.vdot(pd.rhs, pd.rhs)

    def proj(z):                                 # onto {b^T z = 0}
        return jnp.where(bb > 0,
                         z - (jnp.vdot(pd.rhs, z) / jnp.maximum(
                             bb, 1e-30)) * pd.rhs, z)

    r0 = _sub(CR, M(dual))                       # S(dual) R
    ls0 = _fv_norm2(r0)
    b = proj(Mt(r0))

    x = jnp.zeros_like(dual)
    r = b
    p = r
    rs0 = jnp.vdot(r, r)
    stop = rel_tol * rel_tol * rs0

    def cond(c):
        it, x, r, p, rs = c
        return jnp.logical_and(it < n_iter, rs > stop)

    def body(c):
        it, x, r, p, rs = c
        Ap = proj(Mt(M(p)))
        denom = jnp.vdot(p, Ap)
        # a non-positive curvature direction means numerical
        # breakdown of the PSD normal operator at this precision:
        # freeze (alpha = 0 ends progress; rs no longer shrinks but
        # the iterate stays the best computed)
        alpha = jnp.where(denom > 0.0, rs / jnp.maximum(denom, 1e-30),
                          0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.vdot(r, r)
        beta = rs_new / jnp.maximum(rs, 1e-30)
        p = r + beta * p
        return (it + 1, x, r, p, rs_new)

    _, x, _, _, _ = jax.lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), x, r, p, rs0))
    ls1 = _fv_norm2(_sub(CR, M(dual + x)))
    return x, jnp.sqrt(ls0), jnp.sqrt(ls1)
