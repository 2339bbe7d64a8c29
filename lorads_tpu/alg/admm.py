"""Phase II — ADMM splitting on X = U V^T.

Per iteration (reference LORADSADMMOptimize,
/root/reference/src_semi/lorads_alg/lorads_admm.c:33-157):

  for each cone: U-update (CG), refresh caches, V-update (CG), refresh;
  LP columns closed-form;  X_bar = (U+V)/2;  objective + DIMACS at
  X_bar (this also REPLACES the constraint-value caches with
  A(X_bar X_bar^T) — reference updateDimacsADMM semantics, kept
  faithfully);  dual ascent at X_bar;  rho schedule with stagnation
  escape; divergence and bad_pd guards.

Device adaptation: blocks inside one bucket update Jacobi-simultaneously
(batched CG over [B, n, r]); buckets update Gauss-Seidel in sequence;
LP columns update Jacobi.  For single-block buckets this matches the
reference exactly; for multi-block buckets the fixed points coincide
and parity is validated empirically (tests/test_solver.py).

The iteration loop runs on device in chunks of <= 50 iterations (the
reference's log cadence, lorads_admm.c:139) between host syncs.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp

from lorads_tpu.alg import aop
from lorads_tpu.alg.aop import ProblemData
from lorads_tpu.alg.cg import cg_solve, cg_solve_ir
from lorads_tpu.alg.state import FactorVec
from lorads_tpu.ops import lp as lp_ops
from lorads_tpu.ops import pattern as pat

# exit codes from a device chunk
RUNNING, CONVERGED, NUM_ERR, BAD_PD, EARLY_STOP, STALLED = 0, 1, 2, 3, 4, 5

# Phase-II pinf exit margin (see pinf_l1_conv in _make_admm_chunk):
# converge to 0.95*tol instead of 1.00*tol so the reported pinf never
# rides the acceptance band's edge.
EXIT_MARGIN = 0.95

# Host-transfer layout of the chunk's "packed" output: one f64 vector
# holds every scalar the host loop reads (f64 is exact for both the
# f32 solve floats and the int32 counters) — a single device_get leaf
# per dispatch, packed inside the jitted graph (see alm.PACK_F).
PACK_F = ("rho", "pobj", "dobj", "pinf_l1", "pinf_inf", "gap")
PACK_I = ("it", "cg_iter", "status")

# Closed-form Sherman-Morrison solve for diag-identity cones (tests
# flip this off to compare against the generic CG path).
_CLOSED_FORM = True


@dataclasses.dataclass
class ADMMStats:
    """Host mirror of lorads_admm_state (def_lorads_solver.h)."""

    rho: float
    iter: int = 0
    cg_iter: int = 0
    pobj: float = 1e30
    dobj: float = 1e30
    pinf_l1: float = 1e30
    pinf_inf: float = 1e30
    gap: float = 1e30
    dinf_l1: float = 1e30
    dinf_inf: float = 1e30
    time: float = 0.0      # wall seconds spent in ADMM phases


def _admm_cache(bk: pat.BucketData, x):
    """Per-bucket ADMM cache of one factor.

    Plain diag-identity cones (Max-Cut) get a CRCache (C @ X,
    [B, n, r]) instead of the 3-component gathered-row cache: the
    closed-form update never calls CG, its W @ X product is
    C @ X + (a .* w) .* X, and its constraint values need only the
    diagonal of sym(X F^T) — so the off-pattern row caches
    (3 x [B, Ko, r], the dominant device-memory item at maxcut
    n >= 200000,
    VERDICT r4 #4) are dead weight, and w_mul_cached's two Ko-row
    segment sums collapse into cmul's single 2Ko-row pass.
    Every other bucket keeps pattern.gather_cache."""
    if _CLOSED_FORM and bk.split and bk.diag_ident and not bk.summed:
        return aop.CRCache(pat.cmul(bk, x))
    return pat.gather_cache(bk, x)


def _update_sdp_var_one(pd: ProblemData, bk: pat.BucketData, update_var,
                        fixed_var, local_vals, constr_sum, dual, rho,
                        cg_tol, cg_max, fcache=None, s_term=None,
                        mixed=False):
    """One side of the splitting for one bucket: solve for U with V
    fixed (LORADSUpdateSDPVarOne, lorads_admm.c:428-480).

    Returns (new_var, new_local_vals, new_constr_sum, cg_iters,
    new_cache) where new_cache holds the UPDATED variable's gathered
    pattern rows (reused as the next update's fixed-side cache and for
    the X_bar refresh).

    Jacobi inside the bucket: every block b must see
    constrValSum - A_b(U_b V_b^T) (its OWN contribution removed, not
    the whole bucket's).  In local coordinates that is a gather of
    rho (S - b) - lambda minus rho * local_vals at the block's slots.
    """
    base = rho * (constr_sum - pd.rhs) - dual
    # M1, per block; summed buckets subtract the CONE total (the sum
    # of the per-shard partials), not the shard's own partial
    w_loc = pat.gather_w(bk, base) - rho * pat.cone_total(bk, local_vals)
    # the fixed factor is constant for the whole CG solve: cache its
    # gathered pattern rows (or C @ fixed for diag-identity cones)
    # once so each CG matvec gathers only the iterate's rows
    if fcache is None:
        fcache = _admm_cache(bk, fixed_var)
    if isinstance(fcache, aop.CRCache):
        # diag-identity: W = C + diag(a .* w), so W @ fixed is the
        # cached C @ fixed plus an elementwise diagonal plane — no
        # build_w scatter, no w_mul segment sums (see _admm_cache)
        M2 = (fcache.cr
              + (bk.a_val_d * w_loc)[:, :, None] * fixed_var
              - rho * fixed_var)
    else:
        W = pat.build_w(bk, w_loc)                      # C + A*(M1)
        M2 = pat.w_mul_cached(bk, W, fixed_var, fcache) \
            - rho * fixed_var
    if s_term is not None:
        # DUAL_U_V variant: M2 +/- S (LORADSRkMatSub_{positive,
        # negative}_S, lorads_admm.c:401-420); the caller signs S
        M2 = M2 + s_term
    rhs = -M2 / rho

    if _CLOSED_FORM and aop._diag_fast(bk):
        # Diag-identity cones (Max-Cut: A_i = a_i e_i e_i^T) make the
        # normal system row-decoupled: N(x)_i = a_i^2 (x_i . v_i) v_i,
        # so each row solves (I + a_i^2 v_i v_i^T) x_i = rhs_i exactly
        # by Sherman-Morrison — the reference's CG solve
        # (lorads_admm.c:428-480, lorads_cgs.c:81-240) collapses to
        # three elementwise passes with ZERO iterations (and an
        # exact solution instead of a tol-truncated one).  Summed
        # (pattern-sharded) diag-parent buckets ride the same formula
        # on the replicated [1, n, r] factors with the full diag map.
        ad = aop._adiag(bk)
        a2 = ad * ad                                       # [B or 1, n]
        vr = jnp.sum(fixed_var * rhs, -1)                  # [B, n]
        vv = jnp.sum(fixed_var * fixed_var, -1)            # [B, n]
        coef = a2 * vr / (1.0 + a2 * vv)
        new_var = rhs - coef[..., None] * fixed_var
        iters = jnp.zeros((), jnp.int32)
    else:
        fuse_adj = bk.split and bk.a_off_unique and not bk.summed
        fuse_dense = bk.dense and bk.a_single_dense

        def make_op(bkx, fx, fcx):
            def op(x):
                uv = pat.uvt_half_cached(bkx, x, fx, fcx)
                if fuse_adj:
                    # A^*(A(.)) is slot-diagonal on the off pattern:
                    # skip the constraint-space round trip
                    Wop = pat.a_adj_a(bkx, uv)
                elif fuse_dense:
                    Wop = pat.a_adj_a_dense(bkx, uv)
                else:
                    vals = pat.cone_total(bkx, pat.constr_vals(bkx, uv))
                    Wop = pat.build_w(bkx, vals, include_obj=False)
                return x + pat.w_mul_cached(bkx, Wop, fx, fcx)
            return op

        op = make_op(bk, fixed_var, fcache)
        if mixed and update_var.dtype == jnp.float64:
            # Mixed-precision CG (VERDICT r2 #1; deviation, default on
            # via LoradsParams.admm_mixed_cg): the CG sweep runs f32
            # on an f32 cast of the same operator data with f64
            # residual accumulation / iterative refinement
            # (cg.cg_solve_ir) — the f64 matvec runs once per
            # refinement pass instead of every CG iteration.  Exit
            # accuracy is unchanged: the stopping
            # rule tests the TRUE f64 residual against the reference
            # criterion.
            f32 = jnp.float32
            op_lo = make_op(
                pat.cast_floats(bk), fixed_var.astype(f32),
                None if fcache is None
                else tuple(a.astype(f32) for a in fcache))
            new_var, iters = cg_solve_ir(op, op_lo, update_var, rhs,
                                         cg_tol, cg_max)
        else:
            new_var, iters = cg_solve(op, update_var, rhs, cg_tol,
                                      cg_max)
    new_cache = _admm_cache(bk, new_var)
    if isinstance(new_cache, aop.CRCache):
        # diag-identity constraint values need only the diagonal of
        # sym(new fixed^T)
        new_local = bk.a_val_d * jnp.sum(new_var * fixed_var, -1)
    else:
        if new_cache is None:
            uv = pat.uvt(bk, new_var, fixed_var)
        else:
            nr, nc = new_cache[0], new_cache[1]
            fr, fc = fcache[0], fcache[1]
            uv = (jnp.sum(new_var * fixed_var, -1),
                  0.5 * (jnp.sum(nr * fc, -1) + jnp.sum(nc * fr, -1)))
        new_local = pat.constr_vals(bk, uv)
    new_sum = constr_sum + pat.scatter_constr(bk, new_local - local_vals)
    return new_var, new_local, new_sum, iters, new_cache


def _update_lp_var(pd: ProblemData, upd, fixed, lp_contrib, constr_sum,
                   dual, rho, s_lp=None):
    """Closed-form LP column updates, Jacobi over columns
    (LORADSUpdateLPVarOne, lorads_admm.c:595-628; the DUAL_U_V
    variant's signed s enters m2, lorads_admm.c:658-660).

    lp_contrib is the cached A_lp(diag(u v)) m-vector.
    """
    lpd = pd.lp
    base_w = rho * (constr_sum - pd.rhs) - dual
    # per-column (Jacobi): wsum_j = c_j + a_j^T base_w
    #                               - rho ||a_j||^2 u_j v_j
    # where the last term removes column j's own contribution from
    # constrValSum analytically (a_j^T a_j (u_j v_j) = ||a_j||^2 u_j v_j).
    base = lp_ops.adjoint_cols(lpd, base_w)
    corr = rho * lpd.col_nrm2sq * upd * fixed
    wsum = lpd.obj + base - corr
    m2 = wsum * fixed - rho * fixed
    if s_lp is not None:
        m2 = m2 + s_lp
    blin = -m2 / rho
    new = blin / (1.0 + lpd.col_nrm2sq * fixed * fixed)
    new_contrib = lp_ops.constr_vals(lpd, new * fixed)
    new_sum = constr_sum + new_contrib - lp_contrib
    return new, new_contrib, new_sum


def _update_lp_var_gs(pd: ProblemData, upd, fixed, lp_contrib,
                      constr_sum, dual, rho, s_lp=None):
    """EXACT reference LP column order: sequential Gauss-Seidel via
    lax.scan, each column's wsum reading the constrValSum already
    updated by the previous columns (lorads_admm.c:595-628 driven by
    lorads_alg_common.c:229-247).  Same per-column closed form as the
    Jacobi sweep (_update_lp_var); only the sweep order differs —
    identical fixed points, different transients on strongly coupled
    columns at low rho.  Serial over columns by construction, so it is
    opt-in (params.lp_gauss_seidel)."""
    lpd = pd.lp
    dt = constr_sum.dtype
    z1 = jnp.zeros((1,), dt)
    rhs1 = jnp.concatenate([pd.rhs, z1])
    dual1 = jnp.concatenate([dual, z1])
    s_arr = s_lp if s_lp is not None else jnp.zeros_like(upd)

    def step(csum, xs):
        con, val, c_j, nrm2, u_j, v_j, s_j = xs
        csum1 = jnp.concatenate([csum, z1])
        # wsum_j = c_j + a_j^T (rho (csum_noj - rhs) - dual) where
        # csum_noj analytically removes column j's own contribution
        base = jnp.sum(val * (rho * (csum1[con] - rhs1[con])
                              - dual1[con]))
        wsum = c_j + base - rho * nrm2 * u_j * v_j
        m2 = wsum * v_j - rho * v_j + s_j
        new_j = (-m2 / rho) / (1.0 + nrm2 * v_j * v_j)
        # fold the column's delta into csum before the next column
        # reads it (padding ids point at m_glob -> dropped)
        csum = csum.at[con].add(val * (new_j - u_j) * v_j,
                                mode="drop")
        return csum, new_j

    new_sum, new = jax.lax.scan(
        step, constr_sum,
        (lpd.pc_con, lpd.pc_val, lpd.obj, lpd.col_nrm2sq, upd, fixed,
         s_arr))
    new_contrib = lp_ops.constr_vals(lpd, new * fixed)
    return new, new_contrib, new_sum


def _update_sdp_var_bucket_gs(pd: ProblemData, bk: pat.BucketData,
                              upd, fixed, local_vals, constr_sum, dual,
                              rho, cg_tol, cg_max, s=None, mixed=False):
    """Sequential Gauss-Seidel over the blocks of one bucket via
    lax.scan — exact reference sweep semantics
    (lorads_alg_common.c:190-214) at the cost of serializing the
    bucket's blocks.  Updates one side (U with V fixed)."""

    def step(csum, xs):
        bk_b, u_b, v_b, loc_b, s_b = xs
        bk1 = jax.tree.map(lambda x: x[None], bk_b)
        u1, loc1, csum1, it, _ = _update_sdp_var_one(
            pd, bk1, u_b[None], v_b[None], loc_b[None], csum, dual,
            rho, cg_tol, cg_max,
            s_term=s_b[None] if s is not None else None, mixed=mixed)
        return csum1, (u1[0], loc1[0], it)

    s_arr = s if s is not None else jnp.zeros_like(upd)
    csum, (u_new, loc_new, iters) = jax.lax.scan(
        step, constr_sum, (bk, upd, fixed, local_vals, s_arr))
    return u_new, loc_new, csum, jnp.sum(iters, dtype=jnp.int32), None


def admm_update_all(pd: ProblemData, U: FactorVec, V: FactorVec,
                    locals_: Tuple, lp_contrib, constr_sum, dual, rho,
                    cg_tol, cg_max, jacobi=False,
                    u_caches=None, v_caches=None, S: FactorVec = None,
                    mixed=False, lp_gs=False):
    """One sweep over buckets (U then V each), then LP.

    Reference: LORADSUpdateSDPVar / LORADSUpdateSDPLPVar
    (lorads_alg_common.c:187-248).  Within a multi-block bucket the
    default is sequential Gauss-Seidel (reference parity; stable);
    jacobi=True updates all blocks of a bucket simultaneously
    (parallel across devices, but can diverge at low rho on strongly
    coupled blocks — validated per use).  jacobi may also be a
    per-bucket tuple of bools: the solver passes True for buckets
    whose blocks touch DISJOINT constraint sets (merged batched
    instances, block-diagonal problems), where the simultaneous
    update is exactly the Gauss-Seidel one (no block reads another's
    constraint slots) at fully vectorized [B, n, r] shapes.

    u_caches/v_caches: per-bucket gathered pattern rows of U/V from
    the previous sweep (None entries recomputed), returned updated.
    """
    u_cones, v_cones = list(U.cones), list(V.cones)
    locals_ = list(locals_)
    nb = len(pd.buckets)
    u_caches = list(u_caches) if u_caches is not None else [None] * nb
    v_caches = list(v_caches) if v_caches is not None else [None] * nb
    cg_total = jnp.zeros((), jnp.int32)
    for j, bk in enumerate(pd.buckets):
        jac = jacobi[j] if isinstance(jacobi, tuple) else jacobi
        simple = jac or bk.B == 1 or bk.summed or bk.rowshard
        s_j = S.cones[j] if S is not None else None
        if simple:
            u_new, loc, constr_sum, it1, uc = _update_sdp_var_one(
                pd, bk, u_cones[j], v_cones[j], locals_[j], constr_sum,
                dual, rho, cg_tol, cg_max, fcache=v_caches[j],
                s_term=s_j, mixed=mixed)
            v_new, loc, constr_sum, it2, vc = _update_sdp_var_one(
                pd, bk, v_cones[j], u_new, loc, constr_sum,
                dual, rho, cg_tol, cg_max, fcache=uc,
                s_term=(-s_j if s_j is not None else None), mixed=mixed)
        else:
            u_new, loc, constr_sum, it1, uc = _update_sdp_var_bucket_gs(
                pd, bk, u_cones[j], v_cones[j], locals_[j], constr_sum,
                dual, rho, cg_tol, cg_max, s=s_j, mixed=mixed)
            v_new, loc, constr_sum, it2, vc = _update_sdp_var_bucket_gs(
                pd, bk, v_cones[j], u_new, loc, constr_sum,
                dual, rho, cg_tol, cg_max,
                s=(-s_j if s_j is not None else None), mixed=mixed)
        u_cones[j], v_cones[j] = u_new, v_new
        u_caches[j], v_caches[j] = uc, vc
        locals_[j] = loc
        cg_total = cg_total + it1 + it2
    lp_u, lp_v = U.lp, V.lp
    if pd.lp is not None:
        s_lp = S.lp if S is not None else None
        upd_fn = _update_lp_var_gs if lp_gs else _update_lp_var
        lp_u, lp_contrib, constr_sum = upd_fn(
            pd, lp_u, lp_v, lp_contrib, constr_sum, dual, rho,
            s_lp=s_lp)
        lp_v, lp_contrib, constr_sum = upd_fn(
            pd, lp_v, lp_u, lp_contrib, constr_sum, dual, rho,
            s_lp=(-s_lp if s_lp is not None else None))
    return (FactorVec(tuple(u_cones), lp_u),
            FactorVec(tuple(v_cones), lp_v),
            tuple(locals_), lp_contrib, constr_sum, cg_total,
            tuple(u_caches), tuple(v_caches))


def _obj_dimacs_xbar(pd: ProblemData, U: FactorVec, V: FactorVec, dual,
                     scale, u_caches=None, v_caches=None):
    """pObj/dObj/pinf/gap at X_bar=(U+V)/2; returns the refreshed caches.

    Reference: calObj_admm + updateDimacsADMM (lorads_admm.c:79-81,
    lorads_alg_common.c:282-300).  Note the caches now hold
    A(X_bar X_bar^T) — kept, matching the reference trajectory.
    X_bar's gathered pattern rows derive from U's and V's caches
    ((u+v)/2) when available — no fresh gathers.
    """
    R = jax.tree.map(lambda u, v: 0.5 * (u + v), U, V)
    if u_caches is not None and v_caches is not None:
        # caches are linear in the factor (gathered rows AND C @ X),
        # so X_bar's cache is the mean of U's and V's
        xcaches = tuple(
            None if (uc is None or vc is None)
            else jax.tree.map(lambda a, b: 0.5 * (a + b), uc, vc)
            for uc, vc in zip(u_caches, v_caches))
        xcaches = tuple(
            _admm_cache(bk, Rb) if xc is None else xc
            for bk, Rb, xc in zip(pd.buckets, R.cones, xcaches))
        pobj, locals_, total = aop.obj_and_auv_cached(pd, R, xcaches)
    else:
        pobj, locals_, total = aop.obj_and_auv(pd, R, R)
    pobj = pobj / scale
    dobj = jnp.vdot(pd.rhs, dual) / scale
    pinf = aop.primal_infeas_l1(pd, total)
    gap = jnp.abs(pobj - dobj) / (1.0 + jnp.abs(pobj) + jnp.abs(dobj))
    lp_contrib = (lp_ops.constr_vals(pd.lp, R.lp * R.lp)
                  if pd.lp is not None else jnp.zeros_like(total))
    return pobj, dobj, pinf, gap, locals_, lp_contrib, total


def make_admm_chunk(params, reopt: bool, bucket_jacobi=(),
                    gap_stop: bool = False):
    """Jitted device loop for <=chunk ADMM iterations, memoized on the
    params fields it bakes in.

    bucket_jacobi: per-bucket bools from the solver marking buckets
    whose blocks touch disjoint constraint sets — those sweep Jacobi
    (== Gauss-Seidel there, but vectorized over the block axis instead
    of a lax.scan serialization).

    gap_stop: the GAP-CONTINUATION variant (see solver.admm_phase):
    convergence additionally requires gap <= phase2Tol (the reference
    exits on pinf alone, lorads_admm.c:110-118, conceding the gap to
    an expensive reopt round), and the stall detector exits on
    no-gap-progress so a hopeless continuation hands off to reopt
    promptly.

    Memoization matters: a fresh ``jax.jit`` per LoradsSolver would
    re-trace the whole phase graph (and re-deserialize it from the
    persistent XLA cache) on every solver instance — host overhead
    that dominates a small ADMM-heavy solve.
    With the shared callable, repeat solves under the same params hit
    the in-process jit cache directly.
    """
    jacobi = getattr(params, "admm_jacobi", False)
    if not jacobi and bucket_jacobi and any(bucket_jacobi):
        jacobi = tuple(bucket_jacobi)
    return _bound_admm_chunk(
        params.rho_freq, params.rho_factor, params.phase2_tol,
        params.phase1_tol, params.rho_celling_admm,
        jacobi, getattr(params, "dual_uv", False),
        bool(getattr(params, "admm_mixed_cg", True)),
        bool(reopt), bool(gap_stop),
        bool(getattr(params, "lp_gauss_seidel", False)))


@functools.lru_cache(maxsize=None)
def _bound_admm_chunk(rho_freq, rho_factor, tol2, tol1, rho_celling,
                      jacobi, dual_uv, mixed_cg, reopt, gap_stop,
                      lp_gs=False):
    """reopt / gap_stop ride as TRACED booleans (VERDICT r3 #4): the
    three chunk flavors used to be three separately-compiled graphs
    per dtype, each a long compile.
    Everything they change (cg tol multiplier, bad_pd limit,
    convergence predicate, rho-schedule offset, stall detector) is a
    scalar select, so ONE compiled graph (the shared _make_admm_chunk
    base) serves all three; the memoized bound wrapper keeps the
    callable identity stable across solver instances (in-process jit
    cache reuse, see make_admm_chunk docstring)."""
    base = _make_admm_chunk(rho_freq, rho_factor, tol2, tol1,
                            rho_celling, jacobi, dual_uv, mixed_cg,
                            lp_gs)

    def bound(*a, **k):
        return base(*a, reopt_f=reopt, gap_stop_f=gap_stop, **k)

    return bound


@functools.lru_cache(maxsize=None)
def _make_admm_chunk(rho_freq, rho_factor, tol2, tol1, rho_celling,
                     jacobi, dual_uv, mixed_cg=True, lp_gs=False):
    escape_pow = float(rho_factor ** round(
        math.log(rho_freq * 100) / math.log(rho_freq)))

    def chunk(pd: ProblemData, U, V, locals_, lp_contrib, constr_sum,
              dual, rho, cur_rho_max, pinf_buf, old_pinf_mean, bad_pd,
              it, pinf_l1_0, gap_0, pobj0, dobj0, scale, iter_celling,
              n_steps, best_gap0, since_best0, best_pinf0=None,
              since_pinf0=None, S=None, reopt_f=False, gap_stop_f=False):
        S_used = S if dual_uv else None
        # trace-time: the IR-CG mixed path only exists for f64 chunks
        mixed = mixed_cg and pd.rhs.dtype == jnp.float64
        cg_tol_mult = jnp.where(reopt_f, 1e-4, 1e-2)
        bad_pd_limit = jnp.where(reopt_f, 200, 800)

        def pinf_l1_conv(pinf_l1, pinf_inf, gap):
            # Exit margin (deviation; VERDICT r3 #6): the reference
            # exits at pinf_inf <= tol exactly (lorads_admm.c:110),
            # which leaves the reported pinf riding the band at
            # 0.99-1.00x tol on the theta families — a 0.1%
            # perturbation flips `converged`.  Converging to
            # EXIT_MARGIN*tol costs a handful of extra iterations
            # (pinf contracts multiplicatively) and reports pinf
            # safely inside the band.
            tol_p = EXIT_MARGIN * tol2
            conv = jnp.where(reopt_f, pinf_l1 <= tol_p,
                             pinf_inf <= tol_p)
            return conv & jnp.where(gap_stop_f, gap <= tol2, True)

        # Per-dispatch CG budget: a chunk of n_steps iterations whose
        # CG solves all hit the 800-iteration cap runs MINUTES on
        # device (matcomp2000: 200 x 2 x 800 matvecs), and the host
        # cannot check the time limit meanwhile.  When the
        # cumulative CG count crosses the budget the chunk simply
        # returns RUNNING and the host re-dispatches — bounded device
        # time, zero effect on chunks whose CG behaves (typical
        # 3-30 iters/solve never comes close).  f64 matvecs cost more
        # than f32 ones, so the f64 budget is tighter — unless the
        # mixed IR-CG runs the sweeps at f32 anyway.
        cg_budget = (24000 if (pd.rhs.dtype == jnp.float32 or mixed)
                     else 4000)

        def cond(c):
            st = c["status"]
            return ((st == RUNNING) & (c["k"] < n_steps)
                    & (c["it"] < iter_celling)
                    & (c["cg_iter"] < cg_budget))

        def body(c):
            cg_tol = jnp.minimum(c["pinf_l1"] * cg_tol_mult, 1e-8)
            (U_, V_, locals__, lpc, csum, cg_it, ucs, vcs) = \
                admm_update_all(
                    pd, c["U"], c["V"], c["locals"], c["lp_contrib"],
                    c["constr_sum"], c["dual"], c["rho"], cg_tol, 800,
                    jacobi=jacobi, u_caches=c["u_caches"],
                    v_caches=c["v_caches"], S=S_used, mixed=mixed,
                    lp_gs=lp_gs)
            pobj, dobj, pinf, gap, locals__, lpc, csum = _obj_dimacs_xbar(
                pd, U_, V_, c["dual"], scale, ucs, vcs)
            pinf_inf = pinf * (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf)

            i32 = lambda v: jnp.asarray(v, jnp.int32)
            # non-finite stats are divergence too: at f32 the iterates
            # can overflow before either threshold trips (1 - 1e-8
            # rounds to 1.0, and NaN compares False), which used to
            # leave a NaN splitting running to the iteration cap
            status = jnp.where(
                (pinf_inf >= 1e10) | (gap >= 1 - 1e-8)
                | ~jnp.isfinite(pinf_inf) | ~jnp.isfinite(gap),
                i32(NUM_ERR), i32(RUNNING))

            bad_pd = c["bad_pd"]
            bad_pd = jnp.where(gap <= tol2 * 5,
                               jnp.maximum(0, bad_pd - 5), bad_pd)
            bad_pd = jnp.where(gap >= tol1 * 1e2, bad_pd + 2,
                               bad_pd).astype(jnp.int32)
            status = jnp.where((status == RUNNING) & (bad_pd >= bad_pd_limit),
                               i32(BAD_PD), status)

            buf = c["pinf_buf"].at[c["count"] % 10].set(pinf_inf)

            conv_now = pinf_l1_conv(pinf, pinf_inf, gap)
            status = jnp.where((status == RUNNING) & conv_now,
                               i32(CONVERGED), status)

            # dual ascent at X_bar (lorads_admm.c:120)
            do_dual = status != CONVERGED
            dual_n = jnp.where(do_dual,
                               c["dual"] + c["rho"] * (pd.rhs - csum),
                               c["dual"])

            # rho schedule (lorads_admm.c:121-138)
            it_n = c["it"]
            it_off = it_n + jnp.where(reopt_f, 0, 1)
            sched_hit = (it_off % rho_freq == 0)
            rho_n = jnp.where(sched_hit, c["rho"] * rho_factor, c["rho"])
            hit_max = sched_hit & (rho_n >= c["cur_rho_max"])
            rho_n = jnp.where(hit_max, c["cur_rho_max"], rho_n)
            esc_hit = hit_max & ((it_off % (rho_freq * 100)) == 0)
            pinf_mean = jnp.sum(jnp.abs(buf)) / 10.0
            escape = (esc_hit & (pinf_mean / c["old_pinf_mean"] >= 0.65)
                      & (pinf_inf > tol2))
            rho_n = jnp.where(escape, rho_n * escape_pow, rho_n)
            cur_rho_max_n = jnp.where(escape, rho_n, c["cur_rho_max"])
            old_mean_n = jnp.where(esc_hit, pinf_mean, c["old_pinf_mean"])
            rho_n = jnp.minimum(rho_n, rho_celling)

            early = (gap <= tol2 * 1e-3) & (pinf <= tol2 * 1e-3)
            status = jnp.where((status == RUNNING) & early,
                               i32(EARLY_STOP), status)

            # f32 dual-noise plateau: with pinf far below tolerance the
            # dual ascent lambda += rho (b - A(X)) is driven by the
            # float32 residual noise floor and the gap random-walks.
            # Detect no-gap-progress and hand off to reopt (whose
            # rescaled ALM polishes the dual) instead of burning the
            # full iteration budget.  (No reference counterpart — the
            # reference is f64 and never reaches this regime.)
            improved = gap < c["best_gap"] * 0.9
            best_gap_n = jnp.minimum(gap, c["best_gap"])
            since_n = jnp.where(improved, 0,
                                c["since_best"] + 1).astype(jnp.int32)
            # pinf noise-floor detector (f32 only): the exit criterion
            # pinf_inf <= tol can demand a pinf_l1 BELOW the f32 ADMM's
            # achievable floor (matcomp2000: needs 2.4e-10, floor
            # ~1.2e-9) — then pinf stops improving while rho
            # climbs and the gap degrades.  30 iterations without a
            # 10% pinf improvement while unconverged -> STALLED, so
            # dtype=auto escalates ~40 iterations sooner than the
            # gap-based detector alone.  f64 never hits this regime.
            p_impr = pinf < c["best_pinf"] * 0.9
            best_pinf_n = jnp.minimum(pinf, c["best_pinf"])
            since_p_n = jnp.where(p_impr, 0,
                                  c["since_pinf"] + 1).astype(jnp.int32)
            # gap continuation (gap_stop_f): pinf has already
            # converged once; exit on no-gap-progress alone so a
            # hopeless push hands off (to f64 continuation or reopt)
            # promptly.  Main phase: no-gap-progress with pinf deep
            # under tol.
            stalled_plain = (since_n >= 50) & (pinf <= tol2 * 0.1)
            if pd.rhs.dtype == jnp.float32:
                # fire ONLY in the l1/inf wedge (pinf_l1 already
                # past the strict tol while the inf-scaled exit
                # still fails): that is the f32-floor regime —
                # matcomp's pinf_l1 sat 5x under tol and flat
                # while pinf_inf was 5x over.  Without the wedge
                # guard this misfired on theta's slow-but-alive
                # descent (pinf 4.7e-4 -> 4.2e-4 over 80 iters)
                # and sent its whole ADMM phase to f64.
                stalled_plain = stalled_plain | ((since_p_n >= 30)
                                                 & (pinf <= tol2)
                                                 & (pinf_inf > tol2))
            stalled = jnp.where(gap_stop_f, since_n >= 75,
                                stalled_plain)
            status = jnp.where((status == RUNNING) & stalled,
                               i32(STALLED), status)

            return dict(best_gap=best_gap_n, since_best=since_n,
                        best_pinf=best_pinf_n, since_pinf=since_p_n,
                        U=U_, V=V_, locals=tuple(locals__),
                        u_caches=ucs, v_caches=vcs,
                        lp_contrib=lpc, constr_sum=csum, dual=dual_n,
                        rho=rho_n, cur_rho_max=cur_rho_max_n,
                        pinf_buf=buf, old_pinf_mean=old_mean_n,
                        bad_pd=bad_pd, it=it_n + 1, k=c["k"] + 1,
                        pinf_l1=pinf, pinf_inf=pinf_inf, gap=gap,
                        pobj=pobj, dobj=dobj, status=status,
                        cg_iter=c["cg_iter"] + cg_it,
                        count=c["count"] + 1)

        dt = pd.rhs.dtype
        def init_cache(j, bk, x):
            jac = jacobi[j] if isinstance(jacobi, tuple) else jacobi
            if jac or bk.B == 1 or bk.summed or bk.rowshard:
                return _admm_cache(bk, x)
            return None

        carry = dict(
            U=U, V=V, locals=tuple(locals_), lp_contrib=lp_contrib,
            u_caches=tuple(init_cache(j, bk, x)
                           for j, (bk, x)
                           in enumerate(zip(pd.buckets, U.cones))),
            v_caches=tuple(init_cache(j, bk, x)
                           for j, (bk, x)
                           in enumerate(zip(pd.buckets, V.cones))),
            constr_sum=constr_sum, dual=dual, rho=rho,
            cur_rho_max=cur_rho_max, pinf_buf=pinf_buf,
            old_pinf_mean=old_pinf_mean, bad_pd=bad_pd, it=it,
            k=jnp.zeros((), jnp.int32), pinf_l1=pinf_l1_0,
            pinf_inf=pinf_l1_0 * (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf),
            gap=gap_0, pobj=pobj0, dobj=dobj0,
            best_gap=best_gap0, since_best=since_best0,
            best_pinf=(pinf_l1_0 if best_pinf0 is None else best_pinf0),
            since_pinf=(jnp.zeros((), jnp.int32) if since_pinf0 is None
                        else since_pinf0),
            status=jnp.zeros((), jnp.int32),
            cg_iter=jnp.zeros((), jnp.int32),
            count=jnp.zeros((), jnp.int32))
        out = jax.lax.while_loop(cond, body, carry)
        out["packed"] = jnp.concatenate(
            [jnp.stack([out[kk].astype(jnp.float64) for kk in PACK_F]),
             jnp.stack([out[kk].astype(jnp.float64) for kk in PACK_I])])
        return out

    return jax.jit(chunk, static_argnames=())


@jax.jit
def admm_init_eval(pd: ProblemData, U: FactorVec, V: FactorVec, dual,
                   scale):
    """Entry evaluation (lorads_admm.c:47-58).  updateDimacsADMM leaves
    the caches holding A(X_bar X_bar^T), so those are returned, plus a
    single-leaf f64 pack of the four scalars for the host."""
    pobj, dobj, pinf, gap, locals_, lp_contrib, total = _obj_dimacs_xbar(
        pd, U, V, dual, scale)
    packed = jnp.stack([pobj, dobj, pinf, gap]).astype(jnp.float64)
    return locals_, lp_contrib, total, packed
