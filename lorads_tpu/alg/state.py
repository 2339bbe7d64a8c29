"""Device-resident solver state pytrees.

The reference scatters state across `lorads_variable` pointer arrays
(/root/reference/src_semi/data/def_lorads_solver.h:12-46).  Here the
factor matrices live in per-bucket stacked arrays [B, n, r] and all of
it is a single pytree that flows through jitted steps.

The "factor vector" seen by L-BFGS (the concatenation of all cones'
R plus the LP columns, reference lorads_solver.c:428-447) is the pytree
``FactorVec`` — dots/axpys are tree reductions.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FactorVec:
    """One 'vector' over all factor variables: tuple of [B, n, r] + [n_lp]."""

    cones: Tuple[jnp.ndarray, ...]
    lp: jnp.ndarray  # [n_lp] (size 0 when no LP block)

    def __add__(self, o):
        return FactorVec(tuple(a + b for a, b in zip(self.cones, o.cones)),
                         self.lp + o.lp)

    def __sub__(self, o):
        return FactorVec(tuple(a - b for a, b in zip(self.cones, o.cones)),
                         self.lp - o.lp)

    def scale(self, t):
        return FactorVec(tuple(t * a for a in self.cones), t * self.lp)

    def axpy(self, t, o):
        """self + t * o."""
        return FactorVec(
            tuple(a + t * b for a, b in zip(self.cones, o.cones)),
            self.lp + t * o.lp)


def fv_dot(a: FactorVec, b: FactorVec) -> jnp.ndarray:
    tot = jnp.vdot(a.lp, b.lp)
    for x, y in zip(a.cones, b.cones):
        tot = tot + jnp.vdot(x, y)
    return tot


def fv_norm2sq(a: FactorVec) -> jnp.ndarray:
    return fv_dot(a, a)


def fv_zeros_like(a: FactorVec) -> FactorVec:
    return FactorVec(tuple(jnp.zeros_like(x) for x in a.cones),
                     jnp.zeros_like(a.lp))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LBFGSHistory:
    """Circular L-BFGS history over FactorVecs.

    Mirrors the reference's doubly-linked node list
    (/root/reference/src_semi/data/def_lorads_lbfgs.h:5-17) as stacked
    arrays with a traced write head.  ``beta = 1/<y,s>`` per slot.
    """

    s: FactorVec        # leaves have leading axis L
    y: FactorVec
    beta: jnp.ndarray   # [L]
    head: jnp.ndarray   # scalar int32: next slot to write
    n_valid: jnp.ndarray  # scalar int32: slots holding usable pairs

    @property
    def length(self) -> int:
        return self.beta.shape[0]


def make_history(template: FactorVec, length: int) -> LBFGSHistory:
    def stack(x):
        return jnp.zeros((length,) + x.shape, dtype=x.dtype)
    return LBFGSHistory(
        s=jax.tree.map(stack, template),
        y=jax.tree.map(stack, template),
        beta=jnp.zeros((length,), dtype=template.lp.dtype),
        head=jnp.zeros((), dtype=jnp.int32),
        n_valid=jnp.zeros((), dtype=jnp.int32),
    )


def _slot(tree, i):
    return jax.tree.map(lambda x: jax.lax.dynamic_index_in_dim(
        x, i, axis=0, keepdims=False), tree)


def _set_slot(tree, i, val):
    return jax.tree.map(
        lambda x, v: jax.lax.dynamic_update_index_in_dim(x, v, i, axis=0),
        tree, val)


def history_push(hist: LBFGSHistory, s: FactorVec,
                 y: FactorVec) -> LBFGSHistory:
    """Store (s, y, beta=1/<y,s>) at the head slot and advance.

    Reference: setlbfgsHisTwo (lorads_alm.c:657-678).
    """
    beta = 1.0 / fv_dot(y, s)
    L = hist.length
    return LBFGSHistory(
        s=_set_slot(hist.s, hist.head, s),
        y=_set_slot(hist.y, hist.head, y),
        beta=hist.beta.at[hist.head].set(beta),
        head=(hist.head + 1) % L,
        n_valid=jnp.minimum(hist.n_valid + 1, L),
    )


def history_reset(hist: LBFGSHistory) -> LBFGSHistory:
    """Invalidate all pairs (reference clearLBFGS=0, lorads_alm.c:1075-1078)."""
    return dataclasses.replace(hist, n_valid=jnp.zeros((), jnp.int32))


def lbfgs_direction_twoloop(hist: LBFGSHistory,
                            grad: FactorVec) -> FactorVec:
    """Two-loop recursion; D = -grad when no valid history.

    Reference: LBFGSDirection (lorads_alm.c:230-391).  Note the
    reference uses no initial-Hessian gamma scaling: H0 = I.
    The number of nodes used is min(#steps since reset, L); invalid
    slots are skipped via a 0/1 weight.
    """
    L = hist.length
    q = grad
    alphas = []
    # newest -> oldest: slots head-1, head-2, ...
    for k in range(L):
        idx = (hist.head - 1 - k) % L
        valid = (k < hist.n_valid).astype(grad.lp.dtype)
        s_k = _slot(hist.s, idx)
        y_k = _slot(hist.y, idx)
        beta_k = hist.beta[idx]
        alpha = valid * beta_k * fv_dot(s_k, q)
        q = q.axpy(-alpha, y_k)
        alphas.append((idx, alpha, valid))
    # oldest -> newest
    for idx, alpha, valid in reversed(alphas):
        s_k = _slot(hist.s, idx)
        y_k = _slot(hist.y, idx)
        beta_k = hist.beta[idx]
        w = valid * (alpha - beta_k * fv_dot(y_k, q))
        q = q.axpy(w, s_k)
    d = q.scale(-1.0)
    # descent safeguard: fall back to steepest descent if <D, g> >= 0
    # (LBFGSDirectionUseGrad, lorads_alm.c:469-489)
    use_grad = fv_dot(d, grad) >= 0
    return jax.tree.map(
        lambda dd, gg: jnp.where(use_grad, -gg, dd), d, grad)


def lbfgs_direction_compact(hist: LBFGSHistory,
                            grad: FactorVec) -> FactorVec:
    """Compact-representation L-BFGS direction (Byrd-Nocedal form).

    NOT the default: mathematically identical to the two-loop
    recursion, but the Gram-matrix formulation squares the conditioning
    of the history dots, and at float32 the accumulated difference
    derails long trajectories (theta300 certified with two-loop but
    ended partial with this form) and costs iterations even on
    maxcut20000 — the fused Gram matmul saves device time per
    iteration but needs more of them.  Kept as a
    tested alternative for future layouts where the 2L+1 sequential
    stages dominate.

    The restructuring: the 2L+1 sequential dot-then-axpy stages become
    ONE fused Gram reduction over the stacked history, tiny L x L
    triangular solves, and one linear combine.  With H0 = I:

        H g = g + S w2 - Y w1,
        w1 = R^{-1} S^T g,
        w2 = R^{-T} [ (D + Y^T Y) w1 - Y^T g ],

    R = chronological upper triangle of S^T Y, D = its diagonal
    (Nocedal & Wright, eq. 7.24).  Invalid slots are masked to an
    identity block so their contribution is exactly zero.
    """
    L = hist.length
    dt = grad.lp.dtype

    # one Gram pass: Z = [S_0..S_{L-1}, Y_0.., g], G = Z Z^T
    # (leaves of hist.s/.y have leading axis L; grad has none)
    s_parts = [x.reshape(L, -1) for x in hist.s.cones] + [
        hist.s.lp.reshape(L, -1)]
    y_parts = [x.reshape(L, -1) for x in hist.y.cones] + [
        hist.y.lp.reshape(L, -1)]
    g_parts = [x.reshape(1, -1) for x in grad.cones] + [
        grad.lp.reshape(1, -1)]
    G = jnp.zeros((2 * L + 1, 2 * L + 1), dt)
    for sp, yp, gp in zip(s_parts, y_parts, g_parts):
        Z = jnp.concatenate([sp, yp, gp], axis=0)
        G = G + jax.lax.dot_general(
            Z, Z, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=dt)

    # chronological slot order: oldest first
    k = jnp.arange(L, dtype=jnp.int32)
    ordr = (hist.head - hist.n_valid + k) % L
    valid = (k < hist.n_valid).astype(dt)
    si, yi = ordr, ordr + L
    StY = G[si[:, None], yi[None, :]]                # s_i . y_j, chron
    YtY = G[yi[:, None], yi[None, :]]
    u = G[si, 2 * L] * valid                         # S^T g
    v = G[yi, 2 * L] * valid                         # Y^T g
    gg = G[2 * L, 2 * L]

    mask2 = valid[:, None] * valid[None, :]
    eye = jnp.eye(L, dtype=dt)
    R = jnp.triu(StY) * mask2 + (1.0 - valid) * eye  # masked-identity
    Dd = jnp.diagonal(StY) * valid + (1.0 - valid)
    YtY = YtY * mask2

    w1 = jax.scipy.linalg.solve_triangular(R, u, lower=False)
    br = (Dd * w1 + YtY @ w1 - v) * valid
    w2 = jax.scipy.linalg.solve_triangular(R, br, lower=False,
                                           trans=1)
    w1 = w1 * valid
    w2 = w2 * valid

    # scatter chron coefficients back to slot order and combine
    cs = jnp.zeros((L,), dt).at[ordr].set(w2)
    cy = jnp.zeros((L,), dt).at[ordr].set(-w1)
    d_cones = tuple(
        -(g + jnp.einsum("l,l...->...", cs, s)
          + jnp.einsum("l,l...->...", cy, y))
        for g, s, y in zip(grad.cones, hist.s.cones, hist.y.cones))
    d_lp = -(grad.lp + jnp.einsum("l,l...->...", cs, hist.s.lp)
             + jnp.einsum("l,l...->...", cy, hist.y.lp))

    # descent safeguard via the small quantities:
    # <d, g> = -(g.g + u.w2 - v.w1)
    dg = -(gg + jnp.vdot(u, w2) - jnp.vdot(v, w1))
    bad = (dg >= 0) | ~jnp.isfinite(dg)
    return FactorVec(
        tuple(jnp.where(bad, -g, d)
              for g, d in zip(grad.cones, d_cones)),
        jnp.where(bad, -grad.lp, d_lp))


# Default direction: the two-loop recursion (reference parity, and the
# more f32-stable form end-to-end; see lbfgs_direction_compact).
lbfgs_direction = lbfgs_direction_twoloop
