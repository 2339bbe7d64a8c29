"""Phase I — Augmented Lagrangian Method on the single factor R.

minimize  <C, RR^T> - lambda^T (A(RR^T) - b) + (rho/2) ||A(RR^T) - b||^2

by L-BFGS directions + exact quartic line search.  Device/host split:

* the inner L-BFGS loop runs entirely on device as a lax.while_loop
  (`inner_chunk`), up to ~800 steps per dispatch;
* dual updates, the rho escalation do-while, and objective/DIMACS
  refreshes are small jitted calls;
* adaptive outer control (EMA stagnation, difficulty grading, rank
  flags, reopt variants) stays in host Python, mirroring
  LORADS_ALMOptimize (/root/reference/src_semi/lorads_alg/lorads_alm.c:991-1255)
  and LORADS_ALMOptimize_reopt (lorads_alm.c:745-987).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from lorads_tpu.alg import aop
from lorads_tpu.alg.aop import ProblemData
from lorads_tpu.alg.linesearch import alm_line_search
from lorads_tpu.alg.state import (FactorVec, LBFGSHistory, fv_norm2sq,
                                  history_push, history_reset,
                                  lbfgs_direction)

EASY, MEDIUM, HARD, SUPER = 0, 1, 2, 3

# FIX_INI_POINT step-by-step trace (lorads_alm.c:1081-1089, 1116-1118):
# per inner iteration, print the L-BFGS direction norm ("nrm2U:") and
# the accepted step ("tau:") — the reference's primary tool for manual
# A/B debugging across implementations.  The solver flips this on with
# params.fix_init_point BEFORE the first trace of the ALM graphs; it
# is a trace-time constant, so flipping it after graphs are cached in
# this process has no effect (use a fresh process per A/B run).
TRACE_FIX_INI = False


@dataclasses.dataclass
class ALMStats:
    """Host-side mutable ALM iteration state (lorads_alm_state analogue,
    /root/reference/src_semi/data/def_lorads_solver.h + lorads_solver.c:1119)."""

    rho: float
    outer_iter: int = 0
    inner_iter: int = 0
    pobj: float = 1e30
    dobj: float = 1e30
    pinf_l1: float = 1e30
    pinf_inf: float = 1e30
    gap: float = 1e30
    tau: float = 0.0
    time: float = 0.0      # wall seconds spent in ALM phases


# ---------------------------------------------------------------------------
# Jitted pieces.
# ---------------------------------------------------------------------------

@jax.jit
def alm_recompute(pd: ProblemData, R: FactorVec, dual, rho):
    """Fresh A(RR^T), gradient and certificate value (ALG_START,
    lorads_alm.c:1010-1014)."""
    _, total = aop.auv(pd, R, R)
    w = rho * (total - pd.rhs) - dual
    g = aop.grad(pd, R, w)
    cert = jnp.sqrt(fv_norm2sq(g)) / (1.0 + pd.c_nrm_inf)
    return total, g, cert


@jax.jit
def alm_dual_and_grad(pd: ProblemData, R: FactorVec, dual, constr_sum, rho):
    """lambda += rho (b - A(X)); then grad/cert at the new dual
    (lorads_alm.c:1151-1153)."""
    dual_n = dual + rho * (pd.rhs - constr_sum)
    w = rho * (constr_sum - pd.rhs) - dual_n
    g = aop.grad(pd, R, w)
    cert = jnp.sqrt(fv_norm2sq(g)) / (1.0 + pd.c_nrm_inf)
    return dual_n, g, cert


def alm_update_rho_body(pd: ProblemData, R: FactorVec, dual, constr_sum,
                        rho, factor, grad0: FactorVec, caches=None):
    """do { rho *= factor; recompute grad } while (0.1/rho >= cert)
    (UpdateRho, lorads_alm.c:1174-1180)."""
    if caches is None:
        caches = aop.gather_caches(pd, R)

    def body(c):
        rho_, _, _ = c
        rho_n = rho_ * factor
        w = rho_n * (constr_sum - pd.rhs) - dual
        g = aop.grad_cached(pd, R, w, caches)
        cert = jnp.sqrt(fv_norm2sq(g)) / (1.0 + pd.c_nrm_inf)
        return rho_n, g, cert

    c = body((rho, grad0, jnp.zeros_like(rho)))
    c = jax.lax.while_loop(lambda c: 0.1 / c[0] >= c[2], body, c)
    return c[0], c[1], c[2]


@jax.jit
def alm_update_rho(pd: ProblemData, R: FactorVec, dual, constr_sum, rho,
                   factor, grad0: FactorVec):
    return alm_update_rho_body(pd, R, dual, constr_sum, rho, factor,
                               grad0)


@jax.jit
def alm_obj_dimacs(pd: ProblemData, R: FactorVec, dual, scale):
    """pObj, dObj, fresh constr_sum, pinf_l1, gap
    (calObj_alm + LORADSCalDualObj + updateDimacsALM)."""
    pobj = aop.obj_only(pd, R, R) / scale
    dobj = jnp.vdot(pd.rhs, dual) / scale
    _, total = aop.auv(pd, R, R)
    pinf = aop.primal_infeas_l1(pd, total)
    gap = jnp.abs(pobj - dobj) / (1.0 + jnp.abs(pobj) + jnp.abs(dobj))
    # in-jit f64 pack: the caller's host fetch is one leaf
    packed = jnp.stack([pobj, dobj, pinf, gap]).astype(jnp.float64)
    return total, packed


def _inner_loop(pd: ProblemData, R: FactorVec, grad: FactorVec,
                hist: LBFGSHistory, dual, constr_sum, cert_val, rho,
                cert_tol, end_sub_tol, end_tau_tol, phase1_tol, gap_ok,
                max_local, check_pinf_conv: bool = True,
                refresh_every: int = 25, caches=None):
    """The inner L-BFGS loop (lorads_alm.c:1073-1150) as one device loop.

    Exits when: certificate satisfied, local iteration cap, tau too
    small, line-search failure, or (init phase only) primal
    infeasibility below phase1Tol.

    ``caches`` are the incremental pattern caches of R
    (aop.gather_caches); per iteration only the new direction D is
    gathered, and the caches advance by tau alongside R.
    """
    pinf_scale = (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf)
    if caches is None:
        caches = aop.gather_caches(pd, R)

    def conv(pinf_l1):
        # check_pinf_conv may be a Python bool (static callers) or a
        # traced bool (outer_chunk's reopt-as-traced-flag collapse)
        return (jnp.asarray(check_pinf_conv)
                & (pinf_l1 * pinf_scale <= phase1_tol) & gap_ok)

    def cond(carry):
        (R_, g_, h_, ca_, cs_, cert_, pinf_, it, tau, num_err,
         tau_small) = carry
        return ((cert_ - cert_tol > end_sub_tol)
                & (it < max_local)
                & (~num_err) & (~tau_small)
                & (~conv(pinf_)))

    def body(carry):
        (R_, g_, h_, ca_, cs_, cert_, pinf_, it, _, _, _) = carry
        # pin the loop carries to the intended placement (no-op off
        # mesh): factors replicated on summed/rowshard meshes, else
        # GSPMD reshards them row-wise and re-gathers per kernel
        R_, g_ = aop.pin_factors(pd, R_), aop.pin_factors(pd, g_)
        h_ = aop.pin_history(pd, h_)
        h_ = jax.lax.cond(it % 300 == 0, history_reset, lambda h: h, h_)
        D = lbfgs_direction(h_, g_)
        if TRACE_FIX_INI:
            # FIX_INI_POINT per-iteration direction-norm trace
            # (lorads_alm.c:1081-1089): the reference's primary
            # cross-implementation A/B debugging printout
            jax.debug.print("nrm2U: {u:.20f}",
                            u=jnp.sqrt(fv_norm2sq(D)))
        q0 = pd.rhs - cs_
        p1, q1, p2, q2, dcaches = aop.obj_and_auv_pair_cached(
            pd, R_, D, ca_)
        p1, q1 = 2.0 * p1, 2.0 * q1
        tau, num = alm_line_search(rho, dual, p1, p2, q0, q1, q2)
        num_err = num == 0
        tau_small = (~num_err) & (jnp.abs(tau) < end_tau_tol)
        ok = (~num_err) & (~tau_small)

        def do_update(_):
            if TRACE_FIX_INI:
                # accepted-step trace (lorads_alm.c:1116-1118)
                jax.debug.print("tau: {t:.20f}", t=tau)
            y0 = g_.scale(-1.0)
            Rn = R_.axpy(tau, D)
            cs_inc = cs_ + tau * q1 + (tau * tau) * q2
            # The reference recomputes A(RR^T) fresh every inner
            # iteration (updateDimacsALM, lorads_alm.c:1128-1130); the
            # incremental sum cs_inc and the pattern caches are exact
            # in exact arithmetic, so both advance incrementally and
            # refresh every `refresh_every` steps for fp hygiene.
            def refresh(_):
                cn = aop.gather_caches(pd, Rn)
                return cn, aop.auv_cached(pd, Rn, cn)

            def keep(_):
                return aop.axpy_caches(ca_, tau, dcaches), cs_inc

            can, total = jax.lax.cond(
                it % refresh_every == refresh_every - 1,
                refresh, keep, None)
            w = rho * (cs_inc - pd.rhs) - dual
            gn = aop.grad_cached(pd, Rn, w, can)
            hn = history_push(h_, D.scale(tau), y0 + gn)
            pinf = aop.primal_infeas_l1(pd, total)
            certn = jnp.sqrt(fv_norm2sq(gn)) / (1.0 + pd.c_nrm_inf)
            return Rn, gn, hn, can, total, certn, pinf

        def no_update(_):
            return R_, g_, h_, ca_, cs_, cert_, pinf_

        Rn, gn, hn, can, csn, certn, pinfn = jax.lax.cond(
            ok, do_update, no_update, None)
        return (Rn, gn, hn, can, csn, certn, pinfn, it + 1, tau,
                num_err, tau_small)

    pinf0 = aop.primal_infeas_l1(pd, constr_sum)
    carry = (R, grad, hist, caches, constr_sum, cert_val, pinf0,
             jnp.zeros((), jnp.int32), jnp.zeros_like(rho),
             jnp.asarray(False), jnp.asarray(False))
    carry = jax.lax.while_loop(cond, body, carry)
    (R, grad, hist, caches, constr_sum, cert_val, pinf_l1, it, tau,
     num_err, tau_small) = carry
    return (R, grad, hist, constr_sum,
            dict(cert_val=cert_val, pinf_l1=pinf_l1, local_iter=it,
                 tau=tau, num_err=num_err, tau_small=tau_small),
            caches)


def inner_chunk(pd, R, grad, hist, dual, constr_sum, cert_val, rho,
                cert_tol, end_sub_tol, end_tau_tol, phase1_tol, gap_ok,
                max_local, check_pinf_conv: bool = True,
                refresh_every: int = 25):
    """Jitted single inner-loop dispatch (kept for tests/tools; the
    solver path drives middle_chunk)."""
    out = _inner_chunk_jit(pd, R, grad, hist, dual, constr_sum,
                           cert_val, rho, cert_tol, end_sub_tol,
                           end_tau_tol, phase1_tol, gap_ok, max_local,
                           check_pinf_conv=check_pinf_conv,
                           refresh_every=refresh_every)
    return out[:5]


_inner_chunk_jit = partial(jax.jit, static_argnames=(
    "check_pinf_conv", "refresh_every"))(_inner_loop)


# Exit codes of the device middle loop (one ALM outer iteration's
# L-BFGS passes; mirrors the host control flow of LORADS_ALMOptimize,
# lorads_alm.c:1040-1171).
M_RUNNING, M_EASY, M_CERT_TOL, M_EMA_STOP, M_BUDGET, M_RANK, \
    M_NUM_ERR, M_TAU_SMALL, M_PINF_CONV, M_NO_IMPROVE = range(10)


def _middle_and_rho(pd: ProblemData, R: FactorVec, grad: FactorVec,
                    hist: LBFGSHistory, caches, dual, constr_sum,
                    cert_val, rho, cert_tol, end_sub_tol, end_tau_tol,
                    phase1_tol, gap_ok, max_sub_iter, rank_flag,
                    rank_flag_thres, rank_trigger_armed,
                    rho_update_factor, pinf_l1_init,
                    check_pinf_conv: bool = True,
                    high_acc_mode: bool = False):
    """One ALM outer iteration on device: the middle loop of L-BFGS
    passes (difficulty grading, EMA stagnation, certificate and budget
    checks, dual ascent per pass) followed — unless the phase exits —
    by the rho escalation do-while (UpdateRho).

    The adaptive decisions the reference takes in C host code
    (lorads_alm.c:1040-1190) become scalar device arithmetic.  Rank
    augmentation, logging and reopt control stay outside.

    ``rank_trigger_armed`` = (rank_flag can fire: not at rank cap and
    k - last_outer_start >= 3), computed by the caller.
    """
    dt = pd.rhs.dtype
    i32 = lambda v: jnp.asarray(v, jnp.int32)

    def cond(c):
        return (c["difficulty"] != EASY) & (c["exit"] == M_RUNNING)

    def body(c):
        # --- pre-pass checks, in host order ---
        improved = c["cert_val"] < c["best_cert"] * 0.99
        best_cert = jnp.where(improved, c["cert_val"], c["best_cert"])
        no_improve = jnp.where(improved, 0, c["no_improve"] + 1)

        # EMA stagnation detector (LUtilUpdateCheckEma,
        # lorads_utils.c:404-434), alpha=0.1 thres=0.005 interval=5
        ema_cur = 0.1 * c["cert_val"] + 0.9 * c["ema_cur"]
        at_interval = c["ema_n"] >= 5
        change = (ema_cur - c["ema_old"]) / jnp.where(
            c["ema_old"] == 0.0, 1.0, c["ema_old"])
        ema_go = jnp.where(at_interval & (c["ema_old"] != 0.0),
                           (change >= -0.005) & (change <= 0.005),
                           True)
        ema_old = jnp.where(at_interval, ema_cur, c["ema_old"])
        ema_n = jnp.where(at_interval, 1, c["ema_n"] + 1)

        exit_ = i32(M_RUNNING)
        exit_ = jnp.where(no_improve >= 3, i32(M_NO_IMPROVE), exit_)
        if not high_acc_mode:
            exit_ = jnp.where((exit_ == M_RUNNING) & (~ema_go),
                              i32(M_EMA_STOP), exit_)
        exit_ = jnp.where((exit_ == M_RUNNING)
                          & (c["iter_counter"] >= max_sub_iter),
                          i32(M_BUDGET), exit_)
        exit_ = jnp.where((exit_ == M_RUNNING) & rank_trigger_armed
                          & (c["rank_flag"] >= rank_flag_thres),
                          i32(M_RANK), exit_)
        exit_ = jnp.where((exit_ == M_RUNNING)
                          & (c["cert_val"] <= cert_tol),
                          i32(M_CERT_TOL), exit_)

        def run_pass(c):
            (R1, g1, h1, cs1, info, ca1) = _inner_loop(
                pd, c["R"], c["grad"], c["hist"], c["dual"],
                c["constr_sum"], c["cert_val"], rho, cert_tol,
                end_sub_tol, end_tau_tol, phase1_tol, gap_ok,
                i32(801), check_pinf_conv=check_pinf_conv,
                caches=c["caches"])
            local = info["local_iter"]
            exit2 = i32(M_RUNNING)
            exit2 = jnp.where(info["num_err"], i32(M_NUM_ERR), exit2)
            exit2 = jnp.where((exit2 == M_RUNNING) & info["tau_small"],
                              i32(M_TAU_SMALL), exit2)
            pinf_inf = info["pinf_l1"] * (1.0 + pd.b_nrm1) / (
                1.0 + pd.b_nrm_inf)
            conv = (jnp.asarray(check_pinf_conv)
                    & (pinf_inf <= phase1_tol) & gap_ok)
            exit2 = jnp.where((exit2 == M_RUNNING) & conv,
                              i32(M_PINF_CONV), exit2)

            # dual ascent + fresh gradient (lorads_alm.c:1151-1153);
            # skipped when the phase exits here (num_err / converged),
            # matching the host flow
            def dual_step(_):
                dual_n = c["dual"] + rho * (pd.rhs - cs1)
                w = rho * (cs1 - pd.rhs) - dual_n
                g = aop.grad_cached(pd, R1, w, ca1)
                cert = jnp.sqrt(fv_norm2sq(g)) / (1.0 + pd.c_nrm_inf)
                return dual_n, g, cert

            # host flow: num_err/tau_small/converged all break before
            # the dual ascent (lorads_alm.c:1098-1151)
            do_dual = exit2 == M_RUNNING
            dual_n, g2, cert2 = jax.lax.cond(
                do_dual, dual_step,
                lambda _: (c["dual"], g1, info["cert_val"]), None)

            # difficulty grading (lorads_alm.c:1154-1171)
            difficulty = jnp.where(
                local <= 20, i32(EASY),
                jnp.where(local <= 100, i32(MEDIUM),
                          jnp.where(local < 400, i32(HARD), i32(SUPER))))
            # reopt grades SUPER as HARD
            difficulty = jnp.where(jnp.asarray(check_pinf_conv),
                                   difficulty,
                                   jnp.minimum(difficulty, i32(HARD)))
            rank_inc = jnp.where(
                local <= 20, 0,
                jnp.where(local <= 100, 2,
                          jnp.where(difficulty == HARD, 3, 4)))
            # EASY resets the flag (lorads_alm.c:1156); grading only
            # happens when the pass completes normally (num_err /
            # tau_small / converged break first)
            rank_flag_n = jnp.where(
                exit2 != M_RUNNING, c["rank_flag"],
                jnp.where(local <= 20, 0, c["rank_flag"] + rank_inc))
            return dict(
                c, R=R1, grad=g2, hist=h1, caches=ca1, constr_sum=cs1,
                dual=dual_n,
                cert_val=cert2, pinf_l1=info["pinf_l1"],
                tau=info["tau"], best_cert=best_cert,
                no_improve=no_improve, ema_cur=ema_cur, ema_old=ema_old,
                ema_n=ema_n, iter_counter=c["iter_counter"] + local,
                total_inner=c["total_inner"] + local,
                rank_flag=rank_flag_n,
                difficulty=difficulty, exit=exit2)

        def no_pass(c):
            return dict(c, best_cert=best_cert, no_improve=no_improve,
                        ema_cur=ema_cur, ema_old=ema_old, ema_n=ema_n,
                        exit=exit_)

        return jax.lax.cond(exit_ == M_RUNNING, run_pass, no_pass, c)

    carry = dict(
        R=R, grad=grad, hist=hist, dual=dual, constr_sum=constr_sum,
        caches=caches,
        cert_val=jnp.asarray(cert_val, dt),
        pinf_l1=jnp.asarray(pinf_l1_init, dt), tau=jnp.zeros((), dt),
        best_cert=jnp.asarray(jnp.inf, dt),
        no_improve=jnp.zeros((), jnp.int32),
        ema_cur=jnp.zeros((), dt), ema_old=jnp.zeros((), dt),
        ema_n=jnp.ones((), jnp.int32),
        iter_counter=jnp.ones((), jnp.int32),
        total_inner=jnp.zeros((), jnp.int32),
        rank_flag=jnp.asarray(rank_flag, jnp.int32),
        difficulty=jnp.asarray(HARD, jnp.int32),
        exit=jnp.zeros((), jnp.int32))
    carry = jax.lax.while_loop(cond, body, carry)

    # UpdateRho do-while (lorads_alm.c:1174-1180) + history reset —
    # skipped when the phase exits (num_err / pinf converged)
    phase_exit = (carry["exit"] == M_NUM_ERR) | (
        carry["exit"] == M_PINF_CONV)

    def do_rho(c):
        rho_n, g, cert = alm_update_rho_body(
            pd, c["R"], c["dual"], c["constr_sum"], rho,
            rho_update_factor, c["grad"], caches=c["caches"])
        return dict(c, grad=g, cert_val=cert), rho_n

    def no_rho(c):
        return c, rho

    carry, rho_out = jax.lax.cond(phase_exit, no_rho, do_rho, carry)
    carry["hist"] = jax.lax.cond(
        phase_exit, lambda h: h, history_reset, carry["hist"])
    return carry, rho_out


@partial(jax.jit, static_argnames=("check_pinf_conv", "high_acc_mode"))
def middle_chunk(pd: ProblemData, R: FactorVec, grad: FactorVec,
                 hist: LBFGSHistory, dual, constr_sum, cert_val, rho,
                 cert_tol, end_sub_tol, end_tau_tol, phase1_tol, gap_ok,
                 max_sub_iter, rank_flag, rank_flag_thres,
                 rank_trigger_armed, rho_update_factor, pinf_l1_init,
                 check_pinf_conv: bool = True,
                 high_acc_mode: bool = False):
    """Single-outer device dispatch (kept for tests; the solver path
    drives outer_chunk)."""
    carry, rho_out = _middle_and_rho(
        pd, R, grad, hist, aop.gather_caches(pd, R), dual, constr_sum,
        cert_val, rho, cert_tol, end_sub_tol, end_tau_tol, phase1_tol,
        gap_ok, max_sub_iter, rank_flag, rank_flag_thres,
        rank_trigger_armed, rho_update_factor, pinf_l1_init,
        check_pinf_conv=check_pinf_conv, high_acc_mode=high_acc_mode)
    return (carry["R"], carry["grad"], carry["hist"], carry["dual"],
            carry["constr_sum"], rho_out,
            dict(cert_val=carry["cert_val"], pinf_l1=carry["pinf_l1"],
                 tau=carry["tau"], total_inner=carry["total_inner"],
                 rank_flag=carry["rank_flag"],
                 iter_counter=carry["iter_counter"],
                 exit=carry["exit"]))


# Outer-chunk exit codes.
O_LIMIT, O_DONE, O_NUM_ERR, O_RANK, O_KMAX = range(5)

# ALM grind escalation threshold (auto-history solves): cumulative
# inner iterations in one init ALM phase beyond which the solver
# restarts the phase with L-BFGS history 4 (see alm_optimize).
GRIND_INNER_THRESHOLD = 6000
# single-outer grind symptom: one outer's middle loop needing this
# many L-BFGS iterations marks the short-history ill-conditioned
# regime directly (theta n=800 bench instance: 4005 inners in ONE
# outer at history 2; normal outers run 15-400)
GRIND_OUTER_THRESHOLD = 1500

# per-outer log record layout (device buffer -> host printout)
LOG_COLS = 8  # k, inner, pobj, dobj, pinf_l1, pinf_inf, gap, rho

# Host-transfer layout of outer_chunk's "packed" output: every scalar
# the host needs rides ONE f64 vector (f64 holds both the f32 solve
# floats and all int32 counters exactly), concatenated with the log
# buffer — a single device_get leaf instead of three (each leaf is a
# separate blocking device-to-host transfer).  The pack is computed
# INSIDE the jitted chunk so no eager stack/convert ops dispatch
# either.
PACK_F = ("cert_val", "rho", "rho_factor", "pobj", "dobj",
          "pinf_l1", "pinf_inf", "gap", "tau")
PACK_I = ("rho_flag", "k", "max_sub", "update_max_sub_counter",
          "rank_flag", "total_inner", "mexit", "oexit", "n_done")


# reopt rides as a TRACED boolean (VERDICT r3 #4, same collapse as
# the ADMM chunk): the init and reopt ALM phases share ONE compiled
# graph per dtype — everything reopt changes (pinf-conv exits,
# difficulty grading, loop-top break, termination) is a scalar select.
@partial(jax.jit, static_argnames=(
    "high_acc_mode", "early_stop", "cones_ok", "max_outers"))
def outer_chunk(pd: ProblemData, R: FactorVec, grad: FactorVec,
                hist: LBFGSHistory, dual, constr_sum, cert_val, rho,
                rho_update_factor, rho_factor_flag, k, k0, max_alm_iter,
                max_sub_iter, update_max_sub_counter, rank_flag,
                rank_flag_thres, is_rank_max, last_outer_start,
                pobj0, dobj0, pinf0, gap0, scale_obj,
                end_sub_tol, end_tau_tol, phase1_tol, phase2_tol,
                inner_budget=None,
                reopt: bool = False, high_acc_mode: bool = False,
                early_stop: bool = True, cones_ok: bool = True,
                max_outers: int = 8):
    """Up to ``max_outers`` full ALM outer iterations in ONE device
    dispatch: middle loop + UpdateRho (+history reset) + objective /
    DIMACS refresh + every termination / rank / budget decision of
    LORADS_ALMOptimize's outer loop (lorads_alm.c:991-1255,
    745-987 for the reopt variant).  Only rank augmentation, logging
    (via the returned per-outer record buffer), the wall-clock limit
    and phase transitions remain on host.
    """
    dt = pd.rhs.dtype
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    if inner_budget is None:
        # NOT a jnp default arg: that would create an array (and
        # initialize the XLA backend) at module-import time, breaking
        # jax.distributed.initialize-before-any-jax-call workflows
        inner_budget = i32(2 ** 30)
    check_pinf_conv = jnp.logical_not(reopt)

    def cond(c):
        # inner_budget: traced per-dispatch L-BFGS iteration budget
        # checked BETWEEN outers — the host sizes it from the previous
        # dispatch's measured wall so control returns to the host for
        # the time limit and the log every ~20 s (same mechanism as
        # the ADMM chunks' adaptive n_steps; a single pathological
        # outer is still bounded by MAX_ALM_SUB_ITER)
        return ((c["oexit"] == O_LIMIT) & (c["n_done"] < max_outers)
                & (c["total_inner"] < inner_budget))

    def body(c):
        # ---- loop-top break (k budget) ----
        gap_brk = ((c["gap"] <= jnp.maximum(phase1_tol,
                                            phase2_tol * 5))
                   if high_acc_mode else jnp.asarray(True))
        brk = (c["k"] > max_alm_iter) & jnp.where(
            jnp.asarray(reopt),
            (c["pinf_inf"] <= phase1_tol) & gap_brk, True)

        def do_break(c):
            return dict(c, oexit=i32(O_KMAX))

        def do_outer(c):
            # max_alm_sub_iter adaptation (lorads_alm.c:1044-1049)
            bump = c["update_max_sub_counter"] >= 2
            umsc = jnp.where(bump, 0, c["update_max_sub_counter"])
            max_sub = jnp.where(
                bump, jnp.minimum(c["max_sub"] + 10000, 25000),
                c["max_sub"])

            gap_ok = jnp.asarray(True) if not high_acc_mode else (
                c["gap"] <= phase1_tol)
            armed = (~is_rank_max) & (
                c["k"] - last_outer_start >= 3)

            m, rho_n = _middle_and_rho(
                pd, c["R"], c["grad"], c["hist"], c["caches"],
                c["dual"], c["constr_sum"], c["cert_val"], c["rho"],
                0.1 / c["rho"], end_sub_tol, end_tau_tol, phase1_tol,
                gap_ok, max_sub, c["rank_flag"], rank_flag_thres,
                armed, c["rho_factor"], c["pinf_l1"],
                check_pinf_conv=check_pinf_conv,
                high_acc_mode=high_acc_mode)
            mexit = m["exit"]
            pinf_inf_m = m["pinf_l1"] * (1.0 + pd.b_nrm1) / (
                1.0 + pd.b_nrm_inf)

            oexit = i32(O_LIMIT)
            oexit = jnp.where(mexit == M_NUM_ERR, i32(O_NUM_ERR), oexit)
            oexit = jnp.where(mexit == M_PINF_CONV, i32(O_DONE), oexit)
            umsc = jnp.where(mexit == M_BUDGET, umsc + 1, umsc)
            phase_exit = (mexit == M_NUM_ERR) | (mexit == M_PINF_CONV)

            # rho-factor damping thresholds (lorads_alm.c:1192-1205)
            rf, flag = c["rho_factor"], c["rho_flag"]
            hit4 = (rho_n >= 5e4) & (flag < 4)
            rf = jnp.where(hit4, rf ** 0.25, rf)
            flag = jnp.where(hit4, 4, flag)
            hit6 = (rho_n >= 5e6) & (flag < 6)
            rf = jnp.where(hit6, rf ** 0.25, rf)
            flag = jnp.where(hit6, 6, flag)
            hit8 = (rho_n >= 5e8) & (flag < 8)
            rf = jnp.where(hit8, rf ** 0.25, rf)
            flag = jnp.where(hit8, 8, flag)

            k_n = jnp.where(phase_exit, c["k"], c["k"] + 1)

            # init-mode fast termination (pre-DIMACS, lorads_alm.c:1208)
            fast_done = (jnp.logical_not(reopt) & (oexit == O_LIMIT)
                         & (pinf_inf_m <= phase1_tol) & gap_ok)
            oexit = jnp.where(fast_done, i32(O_DONE), oexit)

            # objective/DIMACS refresh (updateDimacsALM + calObj;
            # replaces the constraint-value cache like the reference)
            pobj = aop.obj_cached(pd, m["R"], m["caches"]) / scale_obj
            dobj = jnp.vdot(pd.rhs, m["dual"]) / scale_obj
            total = aop.auv_cached(pd, m["R"], m["caches"])
            pinf = aop.primal_infeas_l1(pd, total)
            gap = jnp.abs(pobj - dobj) / (
                1.0 + jnp.abs(pobj) + jnp.abs(dobj))
            pinf_inf = pinf * (1.0 + pd.b_nrm1) / (1.0 + pd.b_nrm_inf)
            # exit stats are the refreshed ones (round 4): the host
            # finalize used to re-dispatch alm_obj_dimacs for a fresh
            # DIMACS on phase exit — the refresh above already
            # computed exactly that at m["R"], so return it and the
            # fresh constraint sum directly (one dispatch + one
            # blocking fetch less per ALM phase)
            constr_sum_n = total

            # reopt / strict termination (lorads_alm.c:755-780, 1246)
            if early_stop:
                term_reopt = ((pinf <= phase1_tol)
                              & (gap <= jnp.maximum(phase1_tol,
                                                    phase2_tol * 5))
                              & (k_n - k0 > 1))
            else:
                term_reopt = ((gap <= phase2_tol)
                              & (pinf <= phase2_tol)
                              & (k_n - k0 > 1))
            term = jnp.where(jnp.asarray(reopt), term_reopt,
                             (gap <= phase1_tol * 1e-3)
                             & (pinf <= phase1_tol * 1e-3))
            oexit = jnp.where((oexit == O_LIMIT) & term, i32(O_DONE),
                              oexit)

            # rank augmentation trigger (lorads_alm.c:1227-1236)
            rank_flag_n = m["rank_flag"]
            if cones_ok:
                trig = ((rank_flag_n >= rank_flag_thres)
                        & (~is_rank_max))
                rank_flag_n = jnp.where(trig, 0, rank_flag_n)
                fire = (trig & (k_n - last_outer_start >= 2)
                        & (oexit == O_LIMIT))
                oexit = jnp.where(fire, i32(O_RANK), oexit)

            # per-outer log record
            rec = jnp.stack([
                k_n.astype(dt), m["total_inner"].astype(dt), pobj,
                dobj, pinf, pinf_inf, gap, rho_n])
            logbuf = jax.lax.dynamic_update_index_in_dim(
                c["logbuf"], rec, c["n_done"], axis=0)

            return dict(
                R=m["R"], grad=m["grad"], hist=m["hist"],
                caches=m["caches"], dual=m["dual"],
                constr_sum=constr_sum_n, cert_val=m["cert_val"],
                rho=rho_n, rho_factor=rf, rho_flag=flag, k=k_n,
                max_sub=max_sub, update_max_sub_counter=umsc,
                rank_flag=rank_flag_n,
                total_inner=c["total_inner"] + m["total_inner"],
                pobj=pobj, dobj=dobj, pinf_l1=pinf,
                pinf_inf=pinf_inf, gap=gap,
                tau=m["tau"], mexit=mexit, oexit=oexit,
                n_done=c["n_done"] + 1, logbuf=logbuf)

        return jax.lax.cond(brk, do_break, do_outer, c)

    carry = dict(
        R=R, grad=grad, hist=hist, caches=aop.gather_caches(pd, R),
        dual=dual, constr_sum=constr_sum,
        cert_val=jnp.asarray(cert_val, dt), rho=jnp.asarray(rho, dt),
        rho_factor=jnp.asarray(rho_update_factor, dt),
        rho_flag=i32(rho_factor_flag), k=i32(k),
        max_sub=i32(max_sub_iter),
        update_max_sub_counter=i32(update_max_sub_counter),
        rank_flag=i32(rank_flag), total_inner=jnp.zeros((), jnp.int32),
        pobj=jnp.asarray(pobj0, dt), dobj=jnp.asarray(dobj0, dt),
        pinf_l1=jnp.asarray(pinf0, dt),
        pinf_inf=jnp.asarray(pinf0, dt) * (1.0 + pd.b_nrm1) / (
            1.0 + pd.b_nrm_inf),
        gap=jnp.asarray(gap0, dt), tau=jnp.zeros((), dt),
        mexit=jnp.zeros((), jnp.int32), oexit=i32(O_LIMIT),
        n_done=jnp.zeros((), jnp.int32),
        logbuf=jnp.zeros((max_outers, LOG_COLS), dt))
    carry = jax.lax.while_loop(cond, body, carry)
    carry["packed"] = jnp.concatenate(
        [jnp.stack([carry[kk].astype(jnp.float64) for kk in PACK_F]),
         jnp.stack([carry[kk].astype(jnp.float64) for kk in PACK_I]),
         carry["logbuf"].astype(jnp.float64).ravel()])
    return carry


# ---------------------------------------------------------------------------
# Host-side EMA stagnation detector.
# ---------------------------------------------------------------------------

class EmaDetector:
    """Reference LUtilUpdateCheckEma (lorads_utils.c:404-434)."""

    def __init__(self, alpha=0.1, threshold=0.005, interval=5):
        self.alpha = alpha
        self.threshold = threshold
        self.interval = interval
        self.current = 0.0
        self.old = 0.0
        self.counter = 1

    def update(self, value: float) -> bool:
        result = True
        self.current = self.alpha * value + (1 - self.alpha) * self.current
        if self.counter >= self.interval:
            if self.old != 0.0:
                change = (self.current - self.old) / self.old
                result = -self.threshold <= change <= self.threshold
            self.old = self.current
            self.counter = 1
        else:
            self.counter += 1
        return result


# ---------------------------------------------------------------------------
# Host driver.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ALMResult:
    action: str   # "done" | "aug_rank" | "num_err" | "time_out" | "regrind"
    R: FactorVec
    dual: jnp.ndarray
    hist: LBFGSHistory
    constr_sum: jnp.ndarray
    # a single outer iteration needed >= GRIND_OUTER_THRESHOLD inner
    # iterations in this phase (L-BFGS grind symptom; lets the
    # aug_rank path escalate the history together with the rank)
    super_outer: bool = False


def alm_optimize(pd: ProblemData, params, R: FactorVec, dual, hist,
                 stats: ALMStats, scale_obj: float, is_rank_max: bool,
                 rho_update_factor: float, time_solve_start: float,
                 solver_ctx, reopt: bool = False,
                 early_stop: bool = True,
                 max_alm_iter: Optional[int] = None,
                 log=print) -> ALMResult:
    """Full ALM phase.  Mirrors LORADS_ALMOptimize (init) and
    LORADS_ALMOptimize_reopt control flow.

    ``solver_ctx`` carries the cross-call MAX_ALM_SUB_ITER global
    (reference file-scope int, lorads_alm.c:7) as attribute
    ``max_alm_sub_iter``.
    """
    t0 = time.time()
    if max_alm_iter is None:
        max_alm_iter = params.max_alm_iter
    if not reopt:
        solver_ctx.max_alm_sub_iter = 5000
    update_max_sub_counter = 0
    last_outer_start = 1
    rank_flag = 0
    rank_flag_thres = params.rank_flag_thres
    if not reopt:
        # None-safe: LoradsSolver resolves the auto default before
        # calling in; direct callers get the reference 2.0
        rho_update_factor = (params.alm_rho_factor
                             if params.alm_rho_factor is not None
                             else 2.0)
    rho_factor_flag = 0
    k0 = stats.outer_iter

    # cert_val stays a DEVICE scalar: float()ing it here would force a
    # blocking sync on the recompute dispatch
    constr_sum, grad, cert_val = alm_recompute(pd, R, dual, stats.rho)

    def finalize(action: str) -> ALMResult:
        # stats were already refreshed from the exit dispatch's packed
        # vector (the chunk returns fresh DIMACS at the exit iterate,
        # see outer_chunk) — no extra dispatch needed.  Before any
        # dispatch has run (max_alm_iter=0 edge), recompute fresh.
        if stats.pobj >= 1e29:
            _, packed = alm_obj_dimacs(pd, R, dual, scale_obj)
            pobj, dobj, pinf, gap = jax.device_get(packed)
            stats.pobj, stats.dobj = float(pobj), float(dobj)
            stats.pinf_l1, stats.gap = float(pinf), float(gap)
            stats.pinf_inf = stats.pinf_l1 * (1 + pd.b_nrm1) / (
                1 + pd.b_nrm_inf)
        log(f"Exit ALM: OuterIter:{stats.outer_iter} "
            f"InnerIter:{stats.inner_iter} pObj:{stats.pobj:5.5e} "
            f"dObj:{stats.dobj:5.5e} pInf(1):{stats.pinf_l1:5.5e} "
            f"pdGap:{stats.gap:5.5e} rho:{stats.rho:3.2f} "
            f"Time:{time.time() - t0:3.2f}")
        return ALMResult(action, R, dual, hist, constr_sum)

    k = stats.outer_iter
    dt = pd.rhs.dtype
    cones_ok = True if not reopt else (pd.n_buckets <= 10)
    max_outers = getattr(solver_ctx, "alm_max_outers", 8)
    # adaptive per-dispatch inner-iteration budget (see outer_chunk's
    # cond): persists across ALM calls on the solver so the reopt
    # phase inherits what the initial phase learned
    inner_budget = getattr(solver_ctx, "alm_inner_budget", 0)
    if not inner_budget:
        # First-dispatch sizing BEFORE any wall measurement exists.
        # Per-inner wall scales with the pattern work, so the first
        # budget assumes ~2.5e8 pattern entries per second and targets
        # a dispatch near 8 s, then the measured-wall resize (2x
        # growth cap, 20 s target) ramps it (ROADMAP D1).
        # inner_budget is a TRACED argument of outer_chunk, so this
        # sizing compiles no new graphs.
        work = sum(bk.B * (bk.n * bk.n if bk.dense else bk.K)
                   for bk in pd.buckets)
        per_inner_s = work / 2.5e8
        inner_budget = max(500, min(8000,
                                    int(8.0 / max(per_inner_s, 1e-9))))

    max_outer_inner = 0
    while True:
        t_disp = time.time()
        # while history escalation is still possible, make sure the
        # host regains control exactly when the grind threshold
        # crosses — one adaptive dispatch can otherwise burn tens of
        # thousands of inner iterations before the check below runs
        # (theta n=800's grind once completed inside two large
        # dispatches without ever returning at the threshold)
        budget_eff = inner_budget
        if (getattr(solver_ctx, "_lbfgs_auto", False)
                and solver_ctx.lbfgs_len < 4):
            budget_eff = max(1, min(
                budget_eff, GRIND_INNER_THRESHOLD + 1 - stats.inner_iter))
        out = outer_chunk(
            pd, R, grad, hist, dual, constr_sum,
            jnp.asarray(cert_val, dt), jnp.asarray(stats.rho, dt),
            jnp.asarray(rho_update_factor, dt),
            jnp.asarray(rho_factor_flag, jnp.int32),
            jnp.asarray(k, jnp.int32), jnp.asarray(k0, jnp.int32),
            jnp.asarray(max_alm_iter, jnp.int32),
            jnp.asarray(solver_ctx.max_alm_sub_iter, jnp.int32),
            jnp.asarray(update_max_sub_counter, jnp.int32),
            jnp.asarray(rank_flag, jnp.int32),
            jnp.asarray(rank_flag_thres, jnp.int32),
            jnp.asarray(bool(is_rank_max)),
            jnp.asarray(last_outer_start, jnp.int32),
            jnp.asarray(stats.pobj if stats.pobj < 1e29 else 1e30, dt),
            jnp.asarray(stats.dobj if stats.dobj < 1e29 else 1e30, dt),
            jnp.asarray(stats.pinf_l1 if stats.pinf_l1 < 1e29 else 1e30,
                        dt),
            jnp.asarray(stats.gap if stats.gap < 1e29 else 1e30, dt),
            jnp.asarray(scale_obj, dt),
            jnp.asarray(params.end_alm_sub_tol, dt),
            jnp.asarray(params.end_tau_tol, dt),
            jnp.asarray(params.phase1_tol, dt),
            jnp.asarray(params.phase2_tol, dt),
            inner_budget=jnp.asarray(budget_eff, jnp.int32),
            reopt=reopt, high_acc_mode=params.high_acc_mode,
            early_stop=early_stop, cones_ok=cones_ok,
            max_outers=max_outers)
        # one blocking transfer for everything the host needs
        R, grad, hist, dual, constr_sum = (
            out["R"], out["grad"], out["hist"], out["dual"],
            out["constr_sum"])
        # ONE packed transfer for every host-side scalar: each
        # device_get LEAF is a separate blocking transfer, so the
        # 18 scalars ride one stacked vector + the log buffer
        # single-leaf f64 transfer (see PACK_F/PACK_I): int32 counters
        # are exact in f64, unlike the old through-the-solve-dtype
        # cast (only exact below 2^24 at f32)
        ph = jax.device_get(out["packed"])
        nf, ni = len(PACK_F), len(PACK_I)
        sc = dict(zip(PACK_F, ph[:nf]))
        sc.update(zip(PACK_I, ph[nf:nf + ni]))
        sc["logbuf"] = ph[nf + ni:].reshape(-1, LOG_COLS)
        # resize the next dispatch's budget from this one's measured
        # per-inner-iteration wall (target ~20 s; growth-capped 2x so
        # a compile-laden first measurement only delays ramp-up)
        wall = time.time() - t_disp
        done_inner = max(int(sc["total_inner"]), 1)
        per_it = wall / done_inner
        inner_budget = max(500, min(40000, 2 * inner_budget,
                                    int(20.0 / max(per_it, 1e-6))))
        solver_ctx.alm_inner_budget = inner_budget
        cert_val = float(sc["cert_val"])
        stats.rho = float(sc["rho"])
        rho_update_factor = float(sc["rho_factor"])
        rho_factor_flag = int(sc["rho_flag"])
        k = int(sc["k"])
        solver_ctx.max_alm_sub_iter = int(sc["max_sub"])
        update_max_sub_counter = int(sc["update_max_sub_counter"])
        rank_flag = int(sc["rank_flag"])
        stats.inner_iter += int(sc["total_inner"])
        stats.pobj, stats.dobj = float(sc["pobj"]), float(sc["dobj"])
        stats.pinf_l1 = float(sc["pinf_l1"])
        stats.pinf_inf = float(sc["pinf_inf"])
        stats.gap = float(sc["gap"])
        stats.tau = float(sc["tau"])
        stats.outer_iter = k
        oexit = int(sc["oexit"])
        mexit = int(sc["mexit"])

        inner_before = stats.inner_iter - int(sc["total_inner"])
        acc = 0
        for row in sc["logbuf"][: int(sc["n_done"])]:
            acc += int(row[1])
            max_outer_inner = max(max_outer_inner, int(row[1]))
            log(f"ALM Outer:{int(row[0])} Inner:{inner_before + acc} "
                f"pObj:{row[2]:5.5e} dObj:{row[3]:5.5e} "
                f"pInf(1):{row[4]:5.5e} pInf(Inf):{row[5]:5.5e} "
                f"pdGap:{row[6]:5.5e} rho:{row[7]:3.2f} "
                f"Time:{time.time() - t0:3.2f}")
        if mexit == M_TAU_SMALL:
            log(f"update rho since tau is too small: {stats.tau:5.3e}")

        super_outer = max_outer_inner >= GRIND_OUTER_THRESHOLD
        if oexit == O_NUM_ERR:
            return finalize("num_err")
        if oexit in (O_DONE, O_KMAX):
            return finalize("done")
        if oexit == O_RANK:
            return ALMResult("aug_rank", R, dual, hist, constr_sum,
                             super_outer=super_outer)
        if time.time() - time_solve_start >= params.time_sec_limit:
            return finalize("time_out")
        # ALM grind escalation (round 4; auto-history solves only):
        # an instance whose L-BFGS middle loops pile up thousands of
        # inner iterations under the short auto history is in the
        # ill-conditioned regime where a longer memory pays — on the
        # bench theta n=800 instance: 12198 inners at history 2 vs
        # 3052 inners at history 4
        # (other theta seeds/sizes never cross the threshold; they
        # finish in 2-3.5k inners; on THIS instance the grind sits in
        # the REOPT rounds' rank-growing re-polish, so the check
        # applies to both phases).  The solver restarts the phase
        # from the CURRENT iterate with history 4; explicit
        # lbfgs_list_length keeps exact reference behavior.
        if (getattr(solver_ctx, "_lbfgs_auto", False)
                and solver_ctx.lbfgs_len < 4
                and (stats.inner_iter >= GRIND_INNER_THRESHOLD
                     or super_outer)):
            return ALMResult("regrind", R, dual, hist, constr_sum,
                             super_outer=super_outer)
        # oexit == O_LIMIT: dispatch budget reached, keep going
