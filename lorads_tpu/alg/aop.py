"""Assembled problem operators over all buckets + the LP block.

Puts the per-bucket kernels (ops/pattern.py) and LP kernels (ops/lp.py)
together into whole-problem operations on FactorVecs:

* ``auv``:        A(sym(U V^T)) -> per-bucket locals + global m-vector
* ``obj_auv``:    <C, sym(U V^T)>
* ``grad``:       2 (C + A^*(w)) U   for an m-vector w
                  (reference ALMSetGrad, lorads_alm.c:9-38)

ProblemData is the single device-resident description of the instance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lorads_tpu.alg.state import FactorVec
from lorads_tpu.core.presolve import Presolved
from lorads_tpu.ops import lp as lp_ops
from lorads_tpu.ops import pattern as pat


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ProblemData:
    """Device-resident instance data (static layout in the pytree)."""

    m: int = dataclasses.field(metadata=dict(static=True))
    buckets: Tuple[pat.BucketData, ...] = ()
    lp: Optional[lp_ops.LPData] = None
    rhs: jnp.ndarray = None          # [m]
    # scalar norm constants (cal_sdp_const, lorads_solver.c:1054-1073)
    c_nrm1: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    c_nrm2: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    c_nrm_inf: float = dataclasses.field(default=0.0,
                                         metadata=dict(static=True))
    b_nrm1: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    b_nrm2: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    b_nrm_inf: float = dataclasses.field(default=0.0,
                                         metadata=dict(static=True))

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def has_lp(self) -> bool:
        return self.lp is not None


def build_problem_data(ps: Presolved, dtype) -> ProblemData:
    buckets = tuple(pat.build_bucket_data(bp, ps.m, dtype)
                    for bp in ps.buckets)
    lpd = (lp_ops.build_lp_data(ps.problem.lp, dtype)
           if ps.problem.lp is not None else None)
    return ProblemData(
        m=ps.m, buckets=buckets, lp=lpd,
        rhs=jnp.asarray(ps.problem.rhs, dtype=dtype),
        c_nrm1=ps.c_nrm1, c_nrm2=ps.c_nrm2, c_nrm_inf=ps.c_nrm_inf,
        b_nrm1=ps.b_nrm1, b_nrm2=ps.b_nrm2, b_nrm_inf=ps.b_nrm_inf,
    )


def scale_bucket(bk, s: float):
    """Scale one bucket's objective data by s (see scale_objective)."""
    repl = dict(c_pat=bk.c_pat * s, c_pat_inner=bk.c_pat_inner * s,
                c_full=bk.c_full * s)
    if bk.split:
        repl.update(c_diag=bk.c_diag * s, c_off=bk.c_off * s,
                    c_off2=bk.c_off2 * s, c_off_cp=bk.c_off_cp * s)
        if bk.c_sym_rs is not None:
            # the full-symmetric C plane consumed by cmul (diag-fast
            # path) must scale with the rest of the objective
            repl.update(c_sym_rs=bk.c_sym_rs * s)
    return dataclasses.replace(bk, **repl)


def scale_objective(pd: ProblemData, s: float) -> ProblemData:
    """Scale C by s in every block (reopt objScale_dualvar,
    lorads_solver.c:1040-1052).  Norm constants intentionally stay
    at their init values, matching the reference."""
    buckets = tuple(scale_bucket(bk, s) for bk in pd.buckets)
    lpd = pd.lp
    if lpd is not None:
        lpd = dataclasses.replace(lpd, obj=lpd.obj * s)
    return dataclasses.replace(pd, buckets=buckets, lp=lpd)


# ---------------------------------------------------------------------------
# Whole-problem operators.
# ---------------------------------------------------------------------------

def pin_factors(pd: ProblemData, fv: FactorVec) -> FactorVec:
    """Pin each cone REPLICATED on its bucket's mesh (no-op for
    buckets without one — dp cones stay block-sharded).  Applied to
    the ALM loop carries: GSPMD otherwise reshards the factors /
    L-BFGS history row-wise mid-loop and re-gathers them at every
    kernel entry (see pattern.BucketData.mesh / DESIGN.md #21).

    Replicated factors are the chosen layout for sp too: pinning the
    summed bucket's factor rows over the mesh instead (so the L-BFGS
    two-loop / axpy / line-search algebra partitions) makes GSPMD
    re-gather the rows at every pattern-kernel gather site, and those
    re-gathers outweighed the partitioned elementwise work when it was
    tried (docs/DESIGN.md #28)."""
    return FactorVec(tuple(pat._pin(bk, x)
                           for bk, x in zip(pd.buckets, fv.cones)),
                     fv.lp)


def pin_history(pd: ProblemData, h):
    """pin_factors over an LBFGSHistory's stacked s/y FactorVecs."""
    return dataclasses.replace(h, s=pin_factors(pd, h.s),
                               y=pin_factors(pd, h.y))


def auv(pd: ProblemData, X: FactorVec, Y: FactorVec):
    """A(sym(X Y^T)): per-bucket local values and the global sum.

    Reference: LORADSInitConstrValAll + InitConstrValSum
    (lorads_alg_common.c:78-84, 134-157).
    Returns (locals: tuple of [B, m_loc], total: [m]).
    """
    locals_ = []
    total = jnp.zeros((pd.m,), dtype=pd.rhs.dtype)
    for bk, U, V in zip(pd.buckets, X.cones, Y.cones):
        vals = pat.constr_vals(bk, pat.uvt(bk, U, V))
        locals_.append(vals)
        total = total + pat.scatter_constr(bk, vals)
    if pd.lp is not None:
        total = total + lp_ops.constr_vals(pd.lp, X.lp * Y.lp)
    return tuple(locals_), total


def obj_and_auv(pd: ProblemData, X: FactorVec, Y: FactorVec):
    """(<C, sym(XY^T)>, locals, total) in one pass (shares the UV^T).

    Reference: LORADSObjConstrValAll (lorads_alg_common.c:105-124).
    """
    locals_ = []
    total = jnp.zeros((pd.m,), dtype=pd.rhs.dtype)
    obj = jnp.zeros((), dtype=pd.rhs.dtype)
    for bk, U, V in zip(pd.buckets, X.cones, Y.cones):
        uvt_val = pat.uvt(bk, U, V)
        obj = obj + jnp.sum(pat.obj_inner(bk, uvt_val))
        vals = pat.constr_vals(bk, uvt_val)
        locals_.append(vals)
        total = total + pat.scatter_constr(bk, vals)
    if pd.lp is not None:
        xy = X.lp * Y.lp
        obj = obj + lp_ops.obj_inner(pd.lp, xy)
        total = total + lp_ops.constr_vals(pd.lp, xy)
    return obj, tuple(locals_), total


def obj_and_auv_pair(pd: ProblemData, R: FactorVec, D: FactorVec):
    """Fused evaluation of <C,.>/A(.) at sym(RD^T) AND sym(DD^T).

    The ALM line search needs both every inner iteration
    (ALMCalq12p12, lorads_alm.c:540-560); fusing shares the pattern
    row/col gathers of R and D (4 gathers instead of 6 per bucket).
    Returns (p1, total1, p2, total2) with p=objective inner products
    and total=global constraint vectors.
    """
    dt = pd.rhs.dtype
    p1 = jnp.zeros((), dt)
    p2 = jnp.zeros((), dt)
    t1 = jnp.zeros((pd.m,), dt)
    t2 = jnp.zeros((pd.m,), dt)
    for bk, Rb, Db in zip(pd.buckets, R.cones, D.cones):
        uv_rd, uv_dd = pat.uvt_pair(bk, Rb, Db)
        p1 = p1 + jnp.sum(pat.obj_inner(bk, uv_rd))
        p2 = p2 + jnp.sum(pat.obj_inner(bk, uv_dd))
        t1 = t1 + pat.scatter_constr(bk, pat.constr_vals(bk, uv_rd))
        t2 = t2 + pat.scatter_constr(bk, pat.constr_vals(bk, uv_dd))
    if pd.lp is not None:
        rd = R.lp * D.lp
        dd = D.lp * D.lp
        p1 = p1 + lp_ops.obj_inner(pd.lp, rd)
        p2 = p2 + lp_ops.obj_inner(pd.lp, dd)
        t1 = t1 + lp_ops.constr_vals(pd.lp, rd)
        t2 = t2 + lp_ops.constr_vals(pd.lp, dd)
    return p1, t1, p2, t2


def obj_only(pd: ProblemData, X: FactorVec, Y: FactorVec) -> jnp.ndarray:
    """<C, sym(XY^T)> (reference LORADSCalObjRR_ALM, lorads_alm.c:1259)."""
    obj = jnp.zeros((), dtype=pd.rhs.dtype)
    for bk, U, V in zip(pd.buckets, X.cones, Y.cones):
        obj = obj + jnp.sum(pat.obj_inner(bk, pat.uvt(bk, U, V)))
    if pd.lp is not None:
        obj = obj + lp_ops.obj_inner(pd.lp, X.lp * Y.lp)
    return obj


def _diag_fast(bk) -> bool:
    """Static gate for the diag-identity ALM fast path: constraints are
    pure diagonal identities (A_i = a_i e_i e_i^T), so A(.) / A^*(.)
    are elementwise and the only sparse work per iteration is one
    C @ D product.  The cache then holds CR = C @ R instead of
    gathered pattern rows.  Also applies to summed (pattern-sharded)
    buckets whose PARENT cone is diag-identity (bk.diag_parent): the
    C @ D partials psum over shards inside cmul, and the diagonal map
    is the replicated a_val_d_full."""
    return bk.split and ((bk.diag_ident and not bk.summed)
                         or bk.diag_parent)


def _adiag(bk):
    """Diagonal constraint coefficients aligned to rows: [B, n] for
    plain diag-identity buckets, the replicated [1, n] full map for
    summed diag-parent shards."""
    return bk.a_val_d_full[:1] if bk.diag_parent else bk.a_val_d


def _scatter_diag(bk, vals):
    """Scatter replicated diag-fast constraint values [B or 1, m_loc]
    into the global m-vector (no per-shard partial sum needed: the
    values are computed once from the replicated factors)."""
    if bk.diag_parent:
        return jax.ops.segment_sum(
            vals[0], bk.glob_idx[0],
            num_segments=bk.m_glob + 1)[: bk.m_glob]
    return pat.scatter_constr(bk, vals)


def _wloc_diag(bk, w_loc):
    """First-shard slice of gather_w output for summed diag-parent
    buckets (the gathered values are replicated across shards)."""
    return w_loc[:1] if bk.diag_parent else w_loc


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CRCache:
    """Diag-fast cache: CR = C @ R.  Its own pytree type so the cached
    operators can statically distinguish it from the gathered-row
    tuples that ADMM builds via pattern.gather_cache."""

    cr: jnp.ndarray


def gather_caches(pd: ProblemData, R: FactorVec):
    """Per-bucket incremental caches of R: CR = C @ R for
    diag-identity buckets (see _diag_fast), gathered pattern rows
    (pattern.gather_cache) otherwise."""
    return tuple(
        CRCache(pat.cmul(bk, Rb)) if _diag_fast(bk)
        else pat.gather_cache(bk, Rb)
        for bk, Rb in zip(pd.buckets, R.cones))


def axpy_caches(caches, t, dcaches):
    """caches + t * dcaches, None entries passed through."""
    return tuple(
        c if c is None else jax.tree.map(lambda a, b: a + t * b, c, d)
        for c, d in zip(caches, dcaches))


def obj_and_auv_pair_cached(pd: ProblemData, R: FactorVec, D: FactorVec,
                            caches):
    """obj_and_auv_pair using R's caches; also returns D's gathered
    rows (dcaches) so the caller can advance the caches by tau."""
    dt = pd.rhs.dtype
    p1 = jnp.zeros((), dt)
    p2 = jnp.zeros((), dt)
    t1 = jnp.zeros((pd.m,), dt)
    t2 = jnp.zeros((pd.m,), dt)
    dcaches = []
    for bk, Rb, Db, cache in zip(pd.buckets, R.cones, D.cones, caches):
        if isinstance(cache, CRCache):
            # <C, sym(RD^T)> = (<R, CD> + <D, CR>)/2;
            # <C, sym(DD^T)> = <D, CD>; A(.) is diagonal-elementwise
            cd = pat.cmul(bk, Db)
            cr = cache.cr
            dcaches.append(CRCache(cd))
            p1 = p1 + 0.5 * (jnp.sum(Rb * cd) + jnp.sum(Db * cr))
            p2 = p2 + jnp.sum(Db * cd)
            t1 = t1 + _scatter_diag(
                bk, _adiag(bk) * jnp.sum(Rb * Db, -1))
            t2 = t2 + _scatter_diag(
                bk, _adiag(bk) * jnp.sum(Db * Db, -1))
            continue
        (uv_rd, uv_dd), dc = pat.uvt_pair_cached(bk, Rb, Db, cache)
        dcaches.append(dc)
        p1 = p1 + jnp.sum(pat.obj_inner(bk, uv_rd))
        p2 = p2 + jnp.sum(pat.obj_inner(bk, uv_dd))
        t1 = t1 + pat.scatter_constr(bk, pat.constr_vals(bk, uv_rd))
        t2 = t2 + pat.scatter_constr(bk, pat.constr_vals(bk, uv_dd))
    if pd.lp is not None:
        rd = R.lp * D.lp
        dd = D.lp * D.lp
        p1 = p1 + lp_ops.obj_inner(pd.lp, rd)
        p2 = p2 + lp_ops.obj_inner(pd.lp, dd)
        t1 = t1 + lp_ops.constr_vals(pd.lp, rd)
        t2 = t2 + lp_ops.constr_vals(pd.lp, dd)
    return p1, t1, p2, t2, tuple(dcaches)


def auv_cached(pd: ProblemData, R: FactorVec, caches):
    """A(sym(RR^T)) global sum from the caches (no factor gathers)."""
    total = jnp.zeros((pd.m,), dtype=pd.rhs.dtype)
    for bk, Rb, cache in zip(pd.buckets, R.cones, caches):
        if isinstance(cache, CRCache):
            total = total + _scatter_diag(
                bk, _adiag(bk) * jnp.sum(Rb * Rb, -1))
            continue
        vals = pat.constr_vals(bk, pat.uvt_from_cache(bk, Rb, cache))
        total = total + pat.scatter_constr(bk, vals)
    if pd.lp is not None:
        total = total + lp_ops.constr_vals(pd.lp, R.lp * R.lp)
    return total


def obj_and_auv_cached(pd: ProblemData, R: FactorVec, caches):
    """obj_and_auv computing the pattern values from R's caches."""
    locals_ = []
    total = jnp.zeros((pd.m,), dtype=pd.rhs.dtype)
    obj = jnp.zeros((), dtype=pd.rhs.dtype)
    for bk, Rb, cache in zip(pd.buckets, R.cones, caches):
        if isinstance(cache, CRCache):
            obj = obj + jnp.sum(Rb * cache.cr)       # <R, CR>
            vals = _adiag(bk) * jnp.sum(Rb * Rb, -1)
            locals_.append(vals)
            total = total + _scatter_diag(bk, vals)
            continue
        uv = pat.uvt_from_cache(bk, Rb, cache)
        obj = obj + jnp.sum(pat.obj_inner(bk, uv))
        vals = pat.constr_vals(bk, uv)
        locals_.append(vals)
        total = total + pat.scatter_constr(bk, vals)
    if pd.lp is not None:
        xy = R.lp * R.lp
        obj = obj + lp_ops.obj_inner(pd.lp, xy)
        total = total + lp_ops.constr_vals(pd.lp, xy)
    return obj, tuple(locals_), total


def obj_cached(pd: ProblemData, R: FactorVec, caches) -> jnp.ndarray:
    """<C, sym(RR^T)> from the caches (no factor gathers)."""
    obj = jnp.zeros((), dtype=pd.rhs.dtype)
    for bk, Rb, cache in zip(pd.buckets, R.cones, caches):
        if isinstance(cache, CRCache):
            obj = obj + jnp.sum(Rb * cache.cr)       # <R, CR>
            continue
        obj = obj + jnp.sum(pat.obj_inner(
            bk, pat.uvt_from_cache(bk, Rb, cache)))
    if pd.lp is not None:
        obj = obj + lp_ops.obj_inner(pd.lp, R.lp * R.lp)
    return obj


def grad_cached(pd: ProblemData, R: FactorVec, w: jnp.ndarray,
                caches) -> FactorVec:
    """grad() consuming R's caches for the W @ R products."""
    cones = []
    for bk, Rb, cache in zip(pd.buckets, R.cones, caches):
        w_loc = pat.gather_w(bk, w)
        if isinstance(cache, CRCache):
            # A^*(w) is diagonal: grad = 2 (CR + (w a_d) . R)
            cones.append(2.0 * (
                cache.cr + (_adiag(bk)
                            * _wloc_diag(bk, w_loc))[:, :, None] * Rb))
            continue
        W = pat.build_w(bk, w_loc)
        cones.append(2.0 * pat.w_mul_cached(bk, W, Rb, cache))
    if pd.lp is not None:
        lp_g = 2.0 * (pd.lp.obj + lp_ops.adjoint_cols(pd.lp, w)) * R.lp
    else:
        lp_g = jnp.zeros_like(R.lp)
    return FactorVec(tuple(cones), lp_g)


def grad(pd: ProblemData, R: FactorVec, w: jnp.ndarray) -> FactorVec:
    """2 (C + A^*(w)) R over all blocks; LP: 2 (c_j + a_j^T w) r_j.

    Reference: ALMCalGrad / ALMSetGradLP (lorads_alm.c:9-100) with
    w = rho (A(RR^T) - b) - lambda computed by the caller.
    """
    cones = []
    for bk, Rb in zip(pd.buckets, R.cones):
        w_loc = pat.gather_w(bk, w)
        if _diag_fast(bk):
            cones.append(2.0 * (
                pat.cmul(bk, Rb)
                + (_adiag(bk)
                   * _wloc_diag(bk, w_loc))[:, :, None] * Rb))
            continue
        W = pat.build_w(bk, w_loc)
        cones.append(2.0 * pat.w_mul(bk, W, Rb))
    if pd.lp is not None:
        lp_g = 2.0 * (pd.lp.obj + lp_ops.adjoint_cols(pd.lp, w)) * R.lp
    else:
        lp_g = jnp.zeros_like(R.lp)
    return FactorVec(tuple(cones), lp_g)


def primal_infeas_l1(pd: ProblemData, total: jnp.ndarray) -> jnp.ndarray:
    """||b - A(X)||_2 / (1 + ||b||_1).

    Reference: primalInfeasibility (lorads_alg_common.c:250-258) — note
    it is a 2-norm despite the "L1" DIMACS label.
    """
    return jnp.linalg.norm(pd.rhs - total) / (1.0 + pd.b_nrm1)
