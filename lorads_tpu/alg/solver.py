"""Solver orchestration: the JAX equivalent of main.c + lorads_solver.c.

Pipeline (reference /root/reference/src_semi/main.c:263-520):

  presolve -> rank policy -> random init -> Phase I (ALM) ->
  handoff -> Phase II (ADMM) -> reopt level 1 -> dual infeasibility ->
  reopt level 2 (x2) -> status classification -> report.

All device work happens through the jitted pieces in alm.py/admm.py;
this module owns lifecycle, dynamic-rank restarts (AUG_RANK), the
objective rescaling of reopt, and the host-side schedule state.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from lorads_tpu.alg import admm as admm_mod
from lorads_tpu.alg import alm as alm_mod
from lorads_tpu.alg import aop
from lorads_tpu.alg.admm import ADMMStats
from lorads_tpu.alg.alm import ALMStats
from lorads_tpu.alg.dualrefine import dual_ls_refine
from lorads_tpu.alg.lanczos import lanczos_min_eig_device
from lorads_tpu.alg.spectral_repair import try_spectral_repair
from lorads_tpu.alg.state import FactorVec, make_history
from lorads_tpu.config import LoradsParams, SolverStatus
from lorads_tpu.core.presolve import Presolved, presolve
from lorads_tpu.core.problem import SDPProblem
from lorads_tpu.ops import lp as lp_ops
from lorads_tpu.ops import pattern as pat


@dataclasses.dataclass
class SolveResult:
    status: SolverStatus
    pobj: float
    dobj: float
    pinf_l1: float
    pinf_inf: float
    dinf_l1: float
    dinf_inf: float
    gap: float
    alm_stats: ALMStats
    admm_stats: ADMMStats
    solve_time: float
    dual_infeas_time: float
    ranks: List[int]
    R: FactorVec                       # X = R R^T (averaged factors)
    dual: np.ndarray


class LoradsSolver:
    """Two-phase low-rank SDP solver (LoRADS rebuild on JAX)."""

    def __init__(self, problem: SDPProblem, params: Optional[LoradsParams]
                 = None, group_buckets: bool = True):
        self.params = params or LoradsParams()
        self.problem = problem
        # FIX_INI_POINT per-iteration debug trace (see
        # alm.TRACE_FIX_INI); trace-time constant — use a fresh
        # process per A/B debugging run
        alm_mod.TRACE_FIX_INI = bool(self.params.fix_init_point)
        # Presolve memo (round 4): repeat solves of the SAME problem
        # object (production re-solve loops, bench steady runs) reuse
        # the host presolve AND the device-resident problem data —
        # both are immutable, and re-uploading them rides the first
        # dispatch that touches them.  Keyed on every params field
        # presolve reads.
        ps_key = (self.params.times_log_rank, self.params.init_rho,
                  self.params.per_matrix_dense_threshold,
                  self.params.dense_dim_threshold,
                  self.params.dense_threshold, group_buckets)
        ps_cache = getattr(problem, "_lorads_ps_cache", None)
        if ps_cache is None:
            ps_cache = {}
            try:
                problem._lorads_ps_cache = ps_cache
            except Exception:
                pass
        if ps_key in ps_cache:
            self.ps: Presolved = ps_cache[ps_key]
        else:
            self.ps = presolve(problem, self.params, group=group_buckets)
            ps_cache[ps_key] = self.ps
        req = self.params.dtype
        if req == "auto":
            # f64 on CPU; on accelerators start f32 and escalate on
            # demand (see maybe_escalate_f64).  Whether the GPU keeps
            # this f32 start is ROADMAP D2.
            req = "f64" if jax.default_backend() == "cpu" else "f32"
        self._auto_dtype = self.params.dtype == "auto"
        self.dtype = jnp.float64 if req == "f64" else jnp.float32
        self.pd = self._problem_data(self.dtype)
        self.m = problem.m
        if self.params.alm_rho_factor is None:
            # structure-based auto (see LoradsParams.alm_rho_factor)
            pure_diag = (self.pd.lp is None and self.pd.buckets
                         and all(bk.diag_ident for bk in self.pd.buckets))
            self.params = dataclasses.replace(
                self.params, alm_rho_factor=3.0 if pure_diag else 2.0)
        self.scale_obj_his = 1.0
        self.max_alm_sub_iter = 5000          # reference global, alm.c:7
        # global last-computed objective/DIMACS values, mirroring
        # ASolver->pObjVal/dObjVal/dimacError which both phases write
        # (the final report uses whichever phase updated them last,
        # main.c:459-465 + lorads_solver.c:960-965)
        self.pobj = 1e30
        self.dobj = 1e30
        self.gap = 1e30
        self.pinf_l1 = 1e30
        self.rho_max = self.params.rho_max
        self.ranks = [bp.rank for bp in self.ps.buckets]
        self.rank_maxes = [bp.rank_max for bp in self.ps.buckets]
        # None -> structure-based auto (see LoradsParams): large
        # dense-mode blocks (the theta shape) take the LONG history —
        # the ill-conditioned high-rho regime grinds catastrophically
        # at the reference's 2 (round-4 re-measurement) — while pure
        # sparse-pattern problems run fastest with 3.
        self.lbfgs_len = self.params.lbfgs_list_length
        self._lbfgs_auto = self.lbfgs_len is None
        if self.lbfgs_len is None:
            big_dense = any(
                bp.dense and bp.n > self.params.dense_dim_threshold
                for bp in self.ps.buckets)
            self.lbfgs_len = 4 if big_dense else 3
        self.log = print if self.params.verbose else (lambda *a, **k: None)
        # dispatch granularity: per-dispatch host overhead dominates
        # small instances, so they get more ALM outers / ADMM
        # iterations per dispatch (time-limit check + log cadence
        # coarsen accordingly)
        total_rows = sum(bp.B * bp.n for bp in self.ps.buckets)
        small = total_rows <= 4096
        self.device_chunk_iters = self.params.device_chunk_iters
        if self.device_chunk_iters is None:
            self.device_chunk_iters = 200 if small else 50
        self.alm_max_outers = 16 if small else 8
        self._rng = np.random.default_rng(self.params.seed)
        self._ident_dirs = None  # lazy (see _identity_directions)
        self._gap_push_stalled = False  # set by the gap continuation
        self._init_vars()
        self.mesh = None
        self._maybe_shard()
        # Buckets whose blocks touch pairwise-disjoint constraint sets
        # (merged batched instances, block-diagonal problems) sweep
        # Jacobi: exactly the Gauss-Seidel update there (no block
        # reads another's constraint slots), but vectorized over the
        # block axis instead of a lax.scan serialization.
        self._bucket_jacobi = tuple(
            len(bp.plans) > 1 and sum(p.m_loc for p in bp.plans)
            == np.unique(np.concatenate(
                [p.loc2glob for p in bp.plans])).size
            for bp in self.ps.buckets)
        self._admm_chunk = admm_mod.make_admm_chunk(
            self.params, False, self._bucket_jacobi)
        self._admm_chunk_reopt = admm_mod.make_admm_chunk(
            self.params, True, self._bucket_jacobi)
        self._admm_chunk_gapstop = admm_mod.make_admm_chunk(
            self.params, False, self._bucket_jacobi, gap_stop=True)

    # ------------------------------------------------------------------
    # Multi-device placement (no reference counterpart; SURVEY.md §2
    # parallelism inventory).
    # ------------------------------------------------------------------


    def _problem_data(self, dtype):
        """Device problem data, memoized per (presolve, dtype): the
        arrays are immutable, so repeat solves (and the f64
        escalation's rebuild) skip the host build AND the device
        re-staging."""
        cache = getattr(self.ps, "_pd_cache", None)
        if cache is None:
            cache = {}
            self.ps._pd_cache = cache
        name = jnp.dtype(dtype).name
        if name not in cache:
            cache[name] = aop.build_problem_data(self.ps, dtype)
        return cache[name]

    def _maybe_shard(self):
        """Place bucket data + factors over all devices (block-axis
        data parallelism).

        shard="auto": activates when >1 device is visible and at least
        one bucket's block axis divides the device count; buckets that
        don't divide stay replicated.  The solver's jitted programs
        then run under GSPMD, with XLA inserting the constraint-vector
        reductions as collectives across the devices — the
        communication pattern validated by parallel/sharded.py's
        shard_map building blocks.  The mesh is 1-D ("blk"): the
        devices of one host reach each other all to all, so only the
        algorithm shapes it.
        """
        mode = getattr(self.params, "shard", "off")
        if mode == "off":
            return
        devs = jax.devices()
        if self.params.n_devices is not None:
            devs = devs[: self.params.n_devices]
        nd = len(devs)
        if nd < 2:
            return
        # dp: bucket block axis divides the mesh.  sp: a single large
        # sparse cone gets its UNION PATTERN sharded instead (summed
        # BucketData, parallel/pattern_sharded.py) — factors stay
        # replicated, the per-shard W.X partials psum over the mesh.
        # tp: a single large DENSE cone gets its O(n^2) intermediates
        # sharded by ROW SLAB (rowshard BucketData,
        # parallel/row_sharded.py) — the per-chip memory ceiling for
        # the n x n objects becomes n^2/D.
        dp_ok = [mode in ("auto", "dp") and bp.B % nd == 0 and bp.B >= nd
                 for bp in self.ps.buckets]
        sp_ok = [mode in ("auto", "sp") and not dp
                 and (not bp.dense) and bp.B == 1 and bp.K >= 16 * nd
                 for bp, dp in zip(self.ps.buckets, dp_ok)]
        # auto only engages tp when the dense block is big enough that
        # slabbing pays (n^2 buffers >= ~64 MB at f32, i.e. n >= 4096);
        # an explicit --shard tp takes any dense cone with n >= 2*nd
        tp_ok = [bp.dense and bp.B == 1 and not dp and not sp
                 and ((mode == "tp" and bp.n >= 2 * nd)
                      or (mode == "auto" and bp.n >= 4096))
                 for bp, dp, sp in zip(self.ps.buckets, dp_ok, sp_ok)]
        if not any(dp_ok) and not any(sp_ok) and not any(tp_ok):
            return
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        self.mesh = Mesh(np.array(devs), ("blk",))
        repl = NamedSharding(self.mesh, P())
        row = NamedSharding(self.mesh, P("blk"))

        def put(tree_, sharded: bool):
            def leaf(x):
                if not hasattr(x, "ndim"):
                    return x
                s = row if (sharded and x.ndim >= 1) else repl
                return jax.device_put(x, s)
            return jax.tree.map(leaf, tree_)

        buckets = []
        for bk, bp, dp, sp, tp in zip(self.pd.buckets, self.ps.buckets,
                                      dp_ok, sp_ok, tp_ok):
            if sp:
                from lorads_tpu.parallel.pattern_sharded import (
                    build_pattern_shards)
                bk = build_pattern_shards(bp.plans[0], self.m, nd,
                                          self.dtype, summed=True,
                                          mesh=self.mesh)
            elif tp:
                from lorads_tpu.parallel.row_sharded import (
                    build_rowshard_bucket)
                bk = build_rowshard_bucket(bp.plans[0], self.m, nd,
                                           self.dtype, mesh=self.mesh)
            if (sp or tp) and self.scale_obj_his != 1.0:
                # the shards are rebuilt from the RAW plan: re-apply
                # any reopt objective scaling (objScale_dualvar)
                bk = aop.scale_bucket(bk, self.scale_obj_his)
            buckets.append(put(bk, dp or sp or tp))
        self.pd = dataclasses.replace(
            self.pd, buckets=tuple(buckets),
            rhs=jax.device_put(self.pd.rhs, repl))
        for name in ("R", "U", "V", "S"):
            fv = getattr(self, name)
            setattr(self, name, FactorVec(
                tuple(jax.device_put(x, row if ok else repl)
                      for x, ok in zip(fv.cones, dp_ok)),
                jax.device_put(fv.lp, repl)))
        self.dual = jax.device_put(self.dual, repl)
        self.hist = make_history(self.R, self.lbfgs_len)
        self.log(f"sharding: {nd}-device mesh, "
                 f"dp buckets {[i for i, ok in enumerate(dp_ok) if ok]}, "
                 f"sp buckets {[i for i, ok in enumerate(sp_ok) if ok]}, "
                 f"tp buckets {[i for i, ok in enumerate(tp_ok) if ok]}")

    # ------------------------------------------------------------------
    # Variables.
    # ------------------------------------------------------------------

    def _rand_factor(self, B, n, r, dims) -> jnp.ndarray:
        """U(-1,1) triangular-distribution init (difference of two
        uniforms), matching LORADS_RANDOM_rk_MAT
        (lorads_solver.c:361-371); padded rows zeroed.  With
        fix_init_point, all-ones (FIX_INI_POINT debug mode,
        lorads_solver.c:441-445) for step-by-step A/B debugging."""
        if self.params.fix_init_point:
            x = np.ones((B, n, r))
        else:
            x = (self._rng.random((B, n, r)) - self._rng.random((B, n, r)))
        for b, d in enumerate(dims):
            x[b, d:, :] = 0.0
        return jnp.asarray(x, dtype=self.dtype)

    def _rand_fv(self) -> FactorVec:
        cones = []
        for bp, r in zip(self.ps.buckets, self.ranks):
            cones.append(self._rand_factor(bp.B, bp.n, r, bp.dims))
        n_lp = self.problem.n_lp_cols
        if self.params.fix_init_point:
            # lpFix: e_1 (lorads_solver.c:391-404)
            lp_np = np.zeros(n_lp)
            if n_lp:
                lp_np[0] = 1.0
            lp = jnp.asarray(lp_np, dtype=self.dtype)
        else:
            lp = jnp.asarray(
                self._rng.random(n_lp) - self._rng.random(n_lp),
                dtype=self.dtype)
        return FactorVec(tuple(cones), lp)

    def _init_vars(self):
        self.R = self._rand_fv()
        # U/V start as aliases of R: the reference draws three
        # independent random inits (lorads_solver.c:406-469) but the
        # handoff overwrites V<-R, U<-V before ADMM ever reads them
        # (LORADS_ALMtoADMM, lorads_solver.c:968-1004), so the extra
        # draws only cost two [B, n, r] device uploads per solve —
        # measurable on the small-instance latency floor (maxcut2000).
        self.U = self.R
        self.V = self.R
        # DUAL_U_V consensus terms: SDP blocks zero-initialized, LP
        # columns random, exactly as the reference allocates them
        # (lorads_solver.c:659-667 / 588-606); never updated.
        n_lp = self.problem.n_lp_cols
        self.S = FactorVec(
            tuple(jnp.zeros_like(x) for x in self.R.cones),
            jnp.asarray(self._rng.random(n_lp) - self._rng.random(n_lp),
                        dtype=self.dtype))
        self.dual = jnp.zeros((self.m,), dtype=self.dtype)
        self.hist = make_history(self.R, self.lbfgs_len)

    # ------------------------------------------------------------------
    # Dynamic rank augmentation (AUG_RANK, lorads_solver.c:806-906).
    # ------------------------------------------------------------------

    def is_rank_max(self) -> bool:
        """CheckAllRankMax (lorads_solver.c:758-774)."""
        return all(min(math.ceil(r), rm) >= rm
                   for r, rm in zip(self.ranks, self.rank_maxes))

    def _pad_cols(self, x: jnp.ndarray, new_r: int) -> jnp.ndarray:
        """Append scaled-identity columns (lpRandomDiag,
        lorads_solver.c:776-786)."""
        B, n, r = x.shape
        aug = new_r - r
        if aug <= 0:
            return x
        rr = min(n, aug)
        newcols = jnp.zeros((B, n, aug), dtype=x.dtype)
        diag = jnp.eye(n, aug, dtype=x.dtype) / math.sqrt(max(rr, 1))
        newcols = newcols + diag[None]
        return jnp.concatenate([x, newcols], axis=2)

    def aug_rank(self, factor: float = 1.5) -> bool:
        """Grow every bucket's rank by `factor` (capped at rank_max);
        returns whether every bucket is now at its cap."""
        new_ranks = [min(math.ceil(r * factor), rm)
                     for r, rm in zip(self.ranks, self.rank_maxes)]
        for i, (r_old, r_new) in enumerate(zip(self.ranks, new_ranks)):
            if r_new >= self.rank_maxes[i]:
                self.log(f"**Rank truncated to sqrt(2m) cap on bucket {i}.")
        self.R = FactorVec(tuple(self._pad_cols(x, nr) for x, nr
                                 in zip(self.R.cones, new_ranks)), self.R.lp)
        self.U = FactorVec(tuple(self._pad_cols(x, nr) for x, nr
                                 in zip(self.U.cones, new_ranks)), self.U.lp)
        self.V = FactorVec(tuple(self._pad_cols(x, nr) for x, nr
                                 in zip(self.V.cones, new_ranks)), self.V.lp)
        self.S = FactorVec(
            tuple(jnp.zeros(x.shape[:2] + (nr,), x.dtype)
                  .at[:, :, :x.shape[2]].set(x)
                  for x, nr in zip(self.S.cones, new_ranks)), self.S.lp)
        self.ranks = new_ranks
        self.hist = make_history(self.R, self.lbfgs_len)
        return self.is_rank_max()

    # ------------------------------------------------------------------
    # Phase I.
    # ------------------------------------------------------------------

    def alm_phase(self, stats: ALMStats, time_solve_start: float,
                  reopt: bool = False, early_stop: bool = True,
                  rho_update_factor: Optional[float] = None,
                  max_alm_iter: Optional[int] = None) -> str:
        factor = (rho_update_factor if rho_update_factor is not None
                  else self.params.alm_rho_factor)
        while True:
            t0 = time.time()
            res = alm_mod.alm_optimize(
                self.pd, self.params, self.R, self.dual, self.hist, stats,
                self.scale_obj_his, self.is_rank_max(), factor,
                time_solve_start, self, reopt=reopt, early_stop=early_stop,
                max_alm_iter=max_alm_iter, log=self.log)
            stats.time += time.time() - t0
            self.R, self.dual, self.hist = res.R, res.dual, res.hist
            self.pobj, self.dobj = stats.pobj, stats.dobj
            self.gap, self.pinf_l1 = stats.gap, stats.pinf_l1
            if res.action == "aug_rank":
                if (self._lbfgs_auto and self.lbfgs_len < 4
                        and res.super_outer):
                    # the rank trigger fired off a SUPER outer: grow
                    # the L-BFGS memory together with the rank (the
                    # grind symptom, see alm.GRIND_OUTER_THRESHOLD)
                    self.lbfgs_len = 4
                    self.log("ALM grind outer detected: escalating "
                             "L-BFGS history to 4 with the rank growth")
                self.log(f"increase the rank, factor:1.5 "
                         f"(ranks {self.ranks} -> caps {self.rank_maxes})")
                self.aug_rank(1.5)
                continue
            if res.action == "regrind":
                # ALM grind escalation (see alm.py): restart the
                # phase from the current iterate with a longer
                # L-BFGS memory
                self.lbfgs_len = 4
                self.hist = make_history(self.R, self.lbfgs_len)
                self.log("ALM grind detected (>=6000 inner "
                         "iterations): escalating L-BFGS history to "
                         "4 and continuing from the current iterate")
                continue
            return res.action

    # ------------------------------------------------------------------
    # Handoff (LORADS_ALMtoADMM, lorads_solver.c:968-1004).
    # ------------------------------------------------------------------

    def alm_to_admm(self, alm_stats: ALMStats, admm_stats: ADMMStats):
        self.V = self.R
        self.U = self.R
        admm_stats.pinf_l1 = alm_stats.pinf_l1
        admm_stats.pinf_inf = alm_stats.pinf_inf
        admm_stats.gap = alm_stats.gap
        admm_stats.rho = alm_stats.rho * self.params.heuristic_factor
        if alm_stats.rho > self.rho_max:
            admm_stats.rho = min(
                math.sqrt(max(self.rho_max, alm_stats.rho) / self.rho_max)
                * self.rho_max, alm_stats.rho)
            self.rho_max = admm_stats.rho

    # ------------------------------------------------------------------
    # Phase II.
    # ------------------------------------------------------------------

    def admm_phase(self, stats: ADMMStats, iter_celling: int,
                   time_solve_start: float, reopt: bool = False) -> str:
        """One ADMM phase with divergence recovery.

        Deviation from the reference: when the NUM_ERR guard trips
        (lorads_admm.c:86-89) the reference keeps the diverged iterates
        and relies on reopt to recover.  (Its ALM also tends to hand
        over at a higher, stabler rho only because of an off-by-one in
        bRHSNrmInf — idamax's 1-based index is used unconverted,
        lorads_solver.c:1061 — which inflates pinf_inf and keeps ALM
        running longer.)  With the norm computed correctly, the
        splitting can genuinely be entered below its stable rho, so we
        snapshot the entry state and on divergence restore it and
        retry at 5x rho (up to twice) before giving up.
        """
        p = self.params
        if stats.gap <= p.phase2_tol and stats.pinf_l1 <= p.phase2_tol:
            return "ok"
        # Preemptive escalation: the ADMM exit (pinf_inf <= tol,
        # lorads_admm.c:110) demands pinf_l1 <= tol (1+binf)/(1+b1).
        # When that target sits below what f32 arithmetic can reach
        # (floor ~1.2e-9 on matcomp2000), every f32 iteration is
        # wasted — enter the phase at f64 directly.  5e-10 is chosen
        # safely below maxcut n=20000's 1e-9 (which f32 handles via
        # its ALM exit) and above matcomp2000's 2.4e-10 (whose f32
        # ADMM otherwise runs until the stall detector fires).
        if self._auto_dtype and self.dtype == jnp.float32 and not reopt:
            need = p.phase2_tol * (1.0 + float(self.pd.b_nrm_inf)) / (
                1.0 + float(self.pd.b_nrm1))
            if need < 5e-10:
                self.maybe_escalate_f64(
                    f"ADMM pinf target {need:.1e} below the f32 floor")
        stats.rho = min(stats.rho, self.rho_max)
        entry = (self.U, self.V, self.dual, stats.rho)
        for attempt in range(3):
            st = self._admm_phase_once(stats, iter_celling,
                                       time_solve_start, reopt)
            if st == "stalled":
                # f32 dual-noise plateau: escalate and continue the
                # same phase at f64; without auto-dtype, hand off to
                # reopt as before
                if self.maybe_escalate_f64("ADMM gap plateau"):
                    st = self._admm_phase_once(stats, iter_celling,
                                               time_solve_start, reopt)
                    return "ok" if st == "stalled" else st
                return "ok"
            if st != "num_err":
                return st
            # restore the entry point — never keep diverged iterates
            self.U, self.V, self.dual, entry_rho = entry
            if attempt == 2:
                break
            stats.rho = min(entry_rho * 5.0, p.rho_celling_admm)
            entry = (self.U, self.V, self.dual, stats.rho)
            self.log(f"ADMM diverged; restored entry state, retrying "
                     f"at rho {stats.rho:.3f}")
        # re-evaluate stats at the restored point so downstream phases
        # see the true state, not the diverged one
        _, _, _, packed = admm_mod.admm_init_eval(
            self.pd, self.U, self.V, self.dual,
            jnp.asarray(self.scale_obj_his, self.dtype))
        pobj, dobj, pinf, gap = jax.device_get(packed)
        stats.pobj, stats.dobj = float(pobj), float(dobj)
        stats.pinf_l1, stats.gap = float(pinf), float(gap)
        stats.pinf_inf = stats.pinf_l1 * (1 + self.pd.b_nrm1) / (
            1 + self.pd.b_nrm_inf)
        self.pobj, self.dobj = stats.pobj, stats.dobj
        self.gap, self.pinf_l1 = stats.gap, stats.pinf_l1
        return "num_err"

    def _admm_phase_once(self, stats: ADMMStats, iter_celling: int,
                         time_solve_start: float, reopt: bool) -> str:
        p = self.params
        chunk_fn = self._admm_chunk_reopt if reopt else self._admm_chunk
        t0 = time.time()

        locals_, lp_contrib, total, packed = \
            admm_mod.admm_init_eval(self.pd, self.U, self.V, self.dual,
                                    jnp.asarray(self.scale_obj_his,
                                                self.dtype))
        pobj, dobj, pinf, gap = jax.device_get(packed)
        stats.pobj, stats.dobj = float(pobj), float(dobj)
        stats.pinf_l1, stats.gap = float(pinf), float(gap)
        stats.pinf_inf = stats.pinf_l1 * (1 + self.pd.b_nrm1) / (
            1 + self.pd.b_nrm_inf)
        if reopt:
            self.log("enter admm reopt")

        dt = self.dtype
        celling = iter_celling
        in_continuation = False
        # Adaptive dispatch sizing: a chunk whose CG solves run long
        # (tight cg_tol near the f32 noise floor) can produce
        # minute-long device programs, during which the host cannot
        # check the time limit or log.  Size each dispatch from the
        # MEASURED per-iteration wall of the previous one, targeting
        # ~20 s; the first (compile-laden) dispatch starts small
        # (ROADMAP D1 questions this wall-clock sizing).
        # per-dtype memory of the learned dispatch size: reopt /
        # continuation / escalated re-entries skip the ramp-up (the
        # f64 entry re-learns from scratch — its per-iteration cost
        # differs from f32's)
        if not hasattr(self, "_admm_n_dev"):
            self._admm_n_dev = {}
        n_dev = self._admm_n_dev.get(
            jnp.dtype(dt).name, min(self.device_chunk_iters, 10))
        disp_target = 20.0
        carry = dict(
            U=self.U, V=self.V, locals_=locals_, lp_contrib=lp_contrib,
            constr_sum=total, dual=self.dual,
            rho=jnp.asarray(stats.rho, dt),
            cur_rho_max=jnp.asarray(self.rho_max, dt),
            pinf_buf=jnp.zeros((10,), dt),
            old_pinf_mean=jnp.asarray(1e30, dt),
            bad_pd=jnp.zeros((), jnp.int32),
            it=jnp.asarray(stats.iter, jnp.int32),
            pinf_l1_0=jnp.asarray(stats.pinf_l1, dt),
            gap_0=jnp.asarray(stats.gap, dt),
            pobj0=jnp.asarray(stats.pobj, dt),
            dobj0=jnp.asarray(stats.dobj, dt),
            best_gap=jnp.asarray(stats.gap, dt),
            since_best=jnp.zeros((), jnp.int32),
            best_pinf=jnp.asarray(stats.pinf_l1, dt),
            since_pinf=jnp.zeros((), jnp.int32))
        scale = jnp.asarray(self.scale_obj_his, dt)
        status = "ok"
        while True:
            it_prev = stats.iter
            t_disp = time.time()
            out = chunk_fn(self.pd, carry["U"], carry["V"],
                           carry["locals_"], carry["lp_contrib"],
                           carry["constr_sum"], carry["dual"], carry["rho"],
                           carry["cur_rho_max"], carry["pinf_buf"],
                           carry["old_pinf_mean"], carry["bad_pd"],
                           carry["it"], carry["pinf_l1_0"], carry["gap_0"],
                           carry["pobj0"], carry["dobj0"], scale,
                           jnp.asarray(celling, jnp.int32),
                           jnp.asarray(n_dev, jnp.int32),
                           carry["best_gap"], carry["since_best"],
                           carry["best_pinf"], carry["since_pinf"],
                           self.S)
            carry = dict(
                U=out["U"], V=out["V"], locals_=out["locals"],
                lp_contrib=out["lp_contrib"], constr_sum=out["constr_sum"],
                dual=out["dual"], rho=out["rho"],
                cur_rho_max=out["cur_rho_max"], pinf_buf=out["pinf_buf"],
                old_pinf_mean=out["old_pinf_mean"], bad_pd=out["bad_pd"],
                it=out["it"], pinf_l1_0=out["pinf_l1"],
                gap_0=out["gap"], pobj0=out["pobj"], dobj0=out["dobj"],
                best_gap=out["best_gap"], since_best=out["since_best"],
                best_pinf=out["best_pinf"],
                since_pinf=out["since_pinf"])
            # one packed SINGLE-LEAF transfer (see alm.PACK_F): the
            # f64 pack is computed inside the jitted chunk, so the
            # host fetch is one device-to-host transfer and the
            # int32 counters are exact (f64 holds int32 exactly)
            ph = jax.device_get(out["packed"])
            scalars = dict(zip(admm_mod.PACK_F, ph[:len(admm_mod.PACK_F)]))
            scalars.update(zip(admm_mod.PACK_I,
                               ph[len(admm_mod.PACK_F):]))
            wall = time.time() - t_disp
            stats.iter = int(scalars["it"])
            stats.cg_iter = int(scalars["cg_iter"])
            # resize the next dispatch from this one's measured
            # per-iteration wall; growth capped at 2x per step so a
            # compile-inflated first measurement only delays the
            # ramp-up, never produces an oversized dispatch
            per_it = wall / max(stats.iter - it_prev, 1)
            n_dev = max(1, min(self.device_chunk_iters, 2 * n_dev,
                               int(disp_target / max(per_it, 1e-4))))
            self._admm_n_dev[jnp.dtype(dt).name] = n_dev
            stats.rho = float(scalars["rho"])
            stats.pobj = float(scalars["pobj"])
            stats.dobj = float(scalars["dobj"])
            stats.pinf_l1 = float(scalars["pinf_l1"])
            stats.pinf_inf = float(scalars["pinf_inf"])
            stats.gap = float(scalars["gap"])
            code = int(scalars["status"])
            nblk = sum(bp.B for bp in self.ps.buckets)
            self.log(
                f"ADMM Iter:{stats.iter} pObj:{stats.pobj:5.5e} "
                f"dObj:{stats.dobj:5.5e} pInf(1):{stats.pinf_l1:5.5e} "
                f"pInf(Inf):{stats.pinf_inf:5.5e} pdGap:{stats.gap:5.5e} "
                f"rho:{stats.rho:3.2f} "
                f"cgIter:{stats.cg_iter // max(nblk, 1)} "
                f"Time:{time.time() - t0:3.2f}")
            if code == admm_mod.NUM_ERR:
                status = "num_err"
                break
            if code == admm_mod.STALLED:
                self.log("ADMM gap plateau"
                         + (" in the gap continuation"
                            if in_continuation else
                            " at the f32 dual-noise floor"))
                if in_continuation and self.dtype == jnp.float64:
                    # the gap's empirical floor was reached under
                    # CONTINUED f64 iteration: remember it so solve()
                    # can skip the level-1 reopt when the plateau is
                    # already inside the classification band (the
                    # reopt re-grinds ALM to move a gap that has just
                    # demonstrably stopped moving — on matcomp2000 the
                    # reopt left the gap at 4.1e-5 vs the
                    # continuation's 3.1e-5 plateau)
                    self._gap_push_stalled = True
                status = "stalled"
                break
            if code in (admm_mod.CONVERGED, admm_mod.EARLY_STOP,
                        admm_mod.BAD_PD):
                # Gap continuation (deviation; see DESIGN.md): the
                # reference ADMM exits on pinf alone
                # (lorads_admm.c:110-118) and concedes gap > tol to a
                # full reopt round (objective rescale + high-rho ALM
                # re-grind + ADMM, about a second whole solve).  When
                # pinf converged but the gap is still above the STRICT
                # tol (the reopt trigger, main.c:376-398), keep the
                # splitting running with gap-inclusive convergence —
                # it is still the same fixed-point iteration, and the
                # device-side stall detector hands off to reopt within
                # 75 no-progress iterations if the push is hopeless.
                # engage only when the gap is within plausible reach
                # (<= 10 tol): from farther out (theta800 exits ADMM
                # at gap 33x tol) the long f32 push leaves a worse
                # dual than the reopt's rescaled ALM polish — level-2's
                # capped rounds then can't certify dinf (theta800 ended
                # primal_optimal with the unguarded push vs
                # primal_dual_optimal through the reopt path)
                if (code == admm_mod.CONVERGED and not reopt
                        and not in_continuation
                        and p.admm_gap_continue
                        and p.phase2_tol < stats.gap <= 10 * p.phase2_tol
                        and stats.pinf_l1 <= p.phase2_tol
                        and stats.iter < iter_celling):
                    in_continuation = True
                    chunk_fn = self._admm_chunk_gapstop
                    celling = min(iter_celling, stats.iter + 2000)
                    # measure gap progress from here, not from the
                    # main phase's tracker
                    carry["best_gap"] = jnp.asarray(stats.gap, dt)
                    carry["since_best"] = jnp.zeros((), jnp.int32)
                    self.log("ADMM gap continuation: pinf converged, "
                             f"pushing gap {stats.gap:.2e} -> "
                             f"{p.phase2_tol:.0e} before conceding to "
                             "reopt")
                    continue
                status = "ok"
                break
            if stats.iter >= celling:
                status = "ok"
                break
            if time.time() - time_solve_start >= self.params.time_sec_limit:
                status = "time_out"
                break
        self.U, self.V, self.dual = carry["U"], carry["V"], carry["dual"]
        self.rho_max = float(carry["cur_rho_max"])
        self.pobj, self.dobj = stats.pobj, stats.dobj
        self.gap, self.pinf_l1 = stats.gap, stats.pinf_l1
        stats.time += time.time() - t0
        return status

    # ------------------------------------------------------------------
    # Mixed-precision escalation (no reference counterpart).
    # ------------------------------------------------------------------

    def maybe_escalate_f64(self, reason: str) -> bool:
        """Switch the solve to float64 when float32's residual noise
        floor blocks the target tolerance (dtype="auto" only).

        The f32 noise floor appears as a gap plateau at ~rho * eps_f32
        with pinf already far below tolerance; f64 is slower per op
        but converges in few iterations at that point.
        """
        if not self._auto_dtype or self.dtype == jnp.float64:
            return False
        self.log(f"escalating to float64 ({reason})")
        self.dtype = jnp.float64
        self.pd = self._problem_data(self.dtype)
        if self.scale_obj_his != 1.0:
            self.pd = aop.scale_objective(self.pd, self.scale_obj_his)
        up = lambda t: jax.tree.map(
            lambda x: x.astype(jnp.float64)
            if hasattr(x, "astype") and x.dtype == jnp.float32 else x, t)
        self.R, self.U, self.V = up(self.R), up(self.U), up(self.V)
        self.S = up(self.S)
        self.dual = self.dual.astype(jnp.float64)
        self.hist = make_history(self.R, self.lbfgs_len)
        if self.mesh is not None:
            self._maybe_shard()   # re-place the rebuilt f64 arrays
        return True

    # ------------------------------------------------------------------
    # Checkpoint / resume (no reference counterpart; SURVEY.md §5).
    # ------------------------------------------------------------------

    def prob_info(self) -> str:
        """Problem dump mirroring the reference's `printfProbInfo`
        (lorads_solver.c:1173-1231): cone counts, block dims, per-cone
        layout view (here: union-pattern size/density and the static
        kernel mode that replaces the reference's runtime cone/matrix
        vtables), and initial ranks."""
        plans = sorted(
            ((bp, bk, pl) for bp, bk in zip(self.ps.buckets,
                                            self.pd.buckets)
             for pl in bp.plans), key=lambda t: t[2].index)
        lines = ["-" * 71, "Problem Information:"]
        lines.append(f"\t 1.Number of SDP Cones:         : "
                     f"{len(plans):10d}")
        lines.append(f"\t 2.Number of LP Cones:          : "
                     f"{self.problem.n_lp_cols:10d}")
        lines.append(f"\t 3.Number of Constraints:       : "
                     f"{self.problem.m:10d}")
        lines.append("\t 4.sdp block dims:              : "
                     + ",".join(f"{pl.dim:3d}" for _, _, pl in plans)
                     + ",")
        for bp, bk, pl in plans:
            tri = pl.dim * (pl.dim + 1) // 2
            if bk.diag_ident or bk.diag_parent:
                # diag_parent: summed (sp) shards of a diag-identity
                # parent cone — per-shard diag_ident is always False,
                # but the kernels ride the same fast path
                mode = "sparse(diag-identity fast path)"
            elif bk.dense:
                mode = "dense(full lower triangle)"
            else:
                mode = "sparse(union pattern)"
            if bk.summed:
                mode += " sharded(sp)"
            if bk.rowshard:
                mode += " sharded(tp: row slabs)"
            lines.append(f"iCone:{pl.index}")
            lines.append(
                f"\t dim:{pl.dim} nConstr:{pl.m_loc} "
                f"unionNnz:{pl.K} density:{pl.K / max(tri, 1):.4f} "
                f"mode:{mode} rank:{bp.rank}")
        lines.append("Initial rank:")
        for bp, _, pl in plans:
            lines.append(f"iCone:{pl.index}, rank:{bp.rank}")
        lines.append("-" * 71)
        return "\n".join(lines)

    def x_blocks(self, R: Optional[FactorVec] = None):
        """Reconstruct the primal solution: dense X_i = R_i R_i^T per
        SDP block (in ORIGINAL block order) plus the LP column values.

        The reference never materializes X (it only reports DIMACS);
        this is an extraction convenience on top of the factors the
        solver already returns (SolveResult.R holds the averaged
        factors, X = R R^T).  Returns (list of [dim_i, dim_i] float64
        arrays, lp values or None).
        """
        R = R if R is not None else self.R
        out = [None] * len(self.ps.plans)
        for bp, Rb in zip(self.ps.buckets, R.cones):
            Rh = np.asarray(Rb, dtype=np.float64)
            for j, plan in enumerate(bp.plans):
                F = Rh[j, : plan.dim]
                out[plan.index] = F @ F.T
        lp_vals = None
        if self.pd.lp is not None:
            u = np.asarray(R.lp, dtype=np.float64)
            lp_vals = u * u
        return out, lp_vals

    def factor_blocks(self, R: Optional[FactorVec] = None):
        """Per-block solution factors F_i with X_i = F_i F_i^T (in
        ORIGINAL block order) plus LP column values.

        O(n*r) storage — the scalable form of :meth:`x_blocks` (a
        dense X at n=100000 would be tens of GB).  Returns (list of
        [dim_i, r] float64 arrays, lp values or None).
        """
        R = R if R is not None else self.R
        out = [None] * len(self.ps.plans)
        for bp, Rb in zip(self.ps.buckets, R.cones):
            Rh = np.asarray(Rb, dtype=np.float64)
            for j, plan in enumerate(bp.plans):
                out[plan.index] = Rh[j, : plan.dim]
        lp_vals = None
        if self.pd.lp is not None:
            u = np.asarray(R.lp, dtype=np.float64)
            lp_vals = u * u
        return out, lp_vals

    def save_solution(self, path: str) -> None:
        """Write the primal/dual solution to an .npz file: per-block
        factors ``f<i>`` (X_i = f_i f_i^T), LP values ``lp`` (if any),
        and the dual vector ``y``.  The reference binary reports only
        DIMACS errors; this is the extraction surface users need to
        consume the solution."""
        # unscale: the internal dual is in reopt-scaled units
        arrs = {"y": (np.asarray(self.dual, dtype=np.float64)
                      / self.scale_obj_his)}
        fs, lp_vals = self.factor_blocks()
        for i, f in enumerate(fs):
            arrs[f"f{i}"] = f
        if lp_vals is not None:
            arrs["lp"] = lp_vals
        np.savez_compressed(path, **arrs)

    def set_initial_factors(self, factors, lp_vals=None,
                            dual=None) -> None:
        """Warm start: seed R/U/V from per-ORIGINAL-block factors
        (the format :meth:`factor_blocks` returns) before solve().

        Production re-solve loop: solve -> factor_blocks -> perturb
        the problem -> set_initial_factors -> solve.  Columns beyond
        the bucket's current rank are truncated; missing columns are
        filled with the scaled identity (the same fill AUG_RANK uses,
        lorads_solver.c:776-786).  ``lp_vals``: nonnegative LP column
        values x (factored as u = sqrt(x)); ``dual``: the UNSCALED
        dual vector (e.g. SolveResult.dual).
        """
        cones = []
        for bp, Rb in zip(self.ps.buckets, self.R.cones):
            new = np.zeros(Rb.shape)
            r = Rb.shape[2]
            for b, plan in enumerate(bp.plans):
                F = np.asarray(factors[plan.index], dtype=np.float64)
                if F.ndim != 2 or F.shape[0] != plan.dim:
                    raise ValueError(
                        f"block {plan.index}: factor shape {F.shape} "
                        f"!= ({plan.dim}, r)")
                k = min(F.shape[1], r)
                new[b, : plan.dim, :k] = F[:, :k]
                if F.shape[1] < r:
                    aug = r - F.shape[1]
                    rr = min(plan.dim, aug)
                    new[b, : plan.dim, F.shape[1]:] = (
                        np.eye(plan.dim, aug) / math.sqrt(max(rr, 1)))
            arr = jnp.asarray(new, self.dtype)
            if hasattr(Rb, "sharding") and self.mesh is not None:
                arr = jax.device_put(arr, Rb.sharding)
            cones.append(arr)
        lp = self.R.lp
        if lp_vals is not None and self.pd.lp is not None:
            x = np.asarray(lp_vals, dtype=np.float64)
            if np.any(x < -1e-12):
                raise ValueError("lp_vals must be nonnegative")
            lp = jnp.asarray(np.sqrt(np.maximum(x, 0.0)), self.dtype)
        fv = FactorVec(tuple(cones), lp)
        self.R = fv
        self.U = fv
        self.V = fv
        if dual is not None:
            self.dual = jnp.asarray(
                np.asarray(dual, np.float64) * self.scale_obj_his,
                self.dtype)
        self.hist = make_history(self.R, self.lbfgs_len)

    def save(self, path: str, alm_stats=None, admm_stats=None,
             phase: str = "alm") -> None:
        from lorads_tpu.utils.checkpoint import save_checkpoint
        save_checkpoint(path, self, alm_stats, admm_stats, phase)

    def load(self, path: str) -> dict:
        from lorads_tpu.utils.checkpoint import load_checkpoint
        return load_checkpoint(path, self)

    # ------------------------------------------------------------------
    # Dual infeasibility certificate.
    # ------------------------------------------------------------------

    def _dual_infeas_pass(self):
        """One Lanczos dispatch: (lp_part, per-bucket min-eig arrays).

        Warm start (round 5, VERDICT r4 #8): re-certifications (the
        repair/refine loops re-measure dinf after every dual step, and
        the final report re-measures after repair) seed each block's
        Krylov space from the PREVIOUS certificate's lowest Ritz
        vector instead of a fresh random vector — the slack moved by a
        small dual step, so the old eigenvector is one restart from
        converged (breakdown-safe: the sweep masks beta ~ 0)."""
        prev = getattr(self, "last_cert_vecs", None)
        v0s = []
        for j, (bk, bp) in enumerate(zip(self.pd.buckets,
                                         self.ps.buckets)):
            b_eff = 1 if (bk.summed or bk.rowshard) else bk.B
            pv = prev[j] if prev is not None else None
            if (pv is not None and pv.shape[0] == b_eff
                    and pv.shape[-1] == bk.n):
                # lowest Ritz/eigh vector per block, already
                # padded-row masked; a small random admixture keeps
                # the Krylov space from inheriting an exactly
                # invariant (possibly stuck) subspace
                mask = (np.arange(bk.n)[None, :]
                        < np.asarray(bp.dims)[:b_eff, None])
                noise = 1e-3 * self._rng.standard_normal(
                    (b_eff, bk.n)) * mask
                v0s.append(pv[:, 0, :].astype(self.dtype)
                           + jnp.asarray(noise, self.dtype))
                continue
            # one logical cone per summed/rowsharded bucket
            v0 = self._rng.standard_normal((b_eff, bk.n))
            # mask padded rows so they stay out of the Krylov space
            v0 *= (np.arange(bk.n)[None, :]
                   < np.asarray(bp.dims)[:b_eff, None])
            v0s.append(jnp.asarray(v0, self.dtype))
        lp_part, lams, restarts, vecs, lams_k = _dual_infeas_device(
            self.pd, self.dual, tuple(v0s))
        lp_part, lams, restarts = jax.device_get((lp_part, lams, restarts))
        # per-bucket Lanczos restart counts (-1 = exact eigh): cost
        # observability for the certificate (VERDICT r2 #5)
        self.last_cert_restarts = [int(r) for r in restarts]
        # per-bucket smallest eigenpairs ([B, kv, n] device arrays +
        # [B, kv] values), for the spectral dual repair
        self.last_cert_vecs = vecs
        self.last_cert_lams_k = lams_k
        out = []
        for lam in lams:
            lam = np.asarray(lam)
            if np.any(np.isnan(lam)):
                # pessimistic fallback: a NaN sweep must not let the
                # status claim optimality
                self.log("warning: Lanczos returned NaN on a block; "
                         "treating its dual slack as infeasible")
                lam = np.where(np.isnan(lam), -1.0, lam)
            out.append(lam)
        return float(lp_part), out

    def _identity_directions(self):
        """Per ORIGINAL block: (constraint slots, coefficients) such
        that adding ``t * coefs`` to ``dual[slots]`` adds ``-t * I``
        to that block's slack S = C - A*(dual) — or None.  Slots must
        be EXCLUSIVE to the block (no other block or LP column touches
        them), so the shift perturbs nothing else.  See
        LoradsParams.dual_repair."""
        if self._ident_dirs is not None:
            return self._ident_dirs
        blocks = self.problem.blocks
        lp = self.problem.lp
        # one global owner-count pass: a slot is exclusive to a block
        # iff exactly one owner (block or LP) touches it — O(total nnz)
        # instead of re-unioning the other K-1 blocks per block (which
        # was quadratic-ish on large merged batches)
        owners = np.zeros(self.problem.m, dtype=np.int32)
        for b in blocks:
            owners[np.unique(b.a_con)] += 1
        if lp is not None:
            owners[np.unique(lp.a_con)] += 1
        shared = owners > 1
        dirs = [_find_identity_direction(blk, shared) for blk in blocks]
        self._ident_dirs = dirs
        return dirs

    def dual_infeasibility(self, stats=None, repair=None) -> float:
        """calculate_dual_infeasibility_solver (lorads_solver.c:1007-1037).

        One jitted dispatch: slack assembly, per-block operator
        normalization, batched Lanczos with on-device restarts and
        tridiagonal eigh (see lanczos_min_eig_device), LP column part.

        With params.dual_repair (extension): any block whose
        constraint span contains its identity gets a negative slack
        eigenvalue removed exactly by a dual shift along that
        direction; dinf is then RE-MEASURED at the shifted dual and
        ``stats``' dObj/gap are refreshed (the shifted dual is a
        feasible dual point — all reported numbers stay honest).
        """
        lp_part, lams = self._dual_infeas_pass()
        if self.params.dual_repair if repair is None else repair:
            delta = self._repair_plan(lp_part, lams)
            if delta is not None:
                self.dual = self.dual + jnp.asarray(delta, self.dtype)
                lp_part, lams = self._dual_infeas_pass()
                dobj = float(jnp.vdot(self.pd.rhs, self.dual))
                dobj /= self.scale_obj_his
                self.dobj = dobj
                self.gap = abs(self.pobj - dobj) / (
                    1.0 + abs(self.pobj) + abs(dobj))
                if stats is not None:
                    stats.dobj = dobj
                    stats.gap = self.gap
                self.log(f"dual repair: shifted dual along identity "
                         f"directions; dObj {dobj:.6e} "
                         f"gap {self.gap:.2e}")
        dinf = lp_part
        for lam in lams:
            dinf += float(np.sum(np.abs(np.minimum(lam, 0.0))))
        dinf /= self.scale_obj_his
        dinf /= (self.pd.c_nrm1 + 1.0)
        return dinf

    def _try_spectral_repair(self, admm_stats) -> bool:
        """Spectral-bundle dual repair — see alg/spectral_repair.py
        (extracted from this module, VERDICT r3 weak #6)."""
        return try_spectral_repair(self, admm_stats)

    def _try_dual_refine(self, admm_stats) -> bool:
        """Direct dual refinement (alg/dualrefine.py, extension): fit
        the dual to complementarity min ||(C - A^*(y)) Rbar||_F^2 by
        CGNR from the current dual, re-certify the candidate with the
        standard certificate (dual_repair composes on top), and accept
        only if the DIMACS acceptance outcome improves.  Replaces the
        reference's level-2 reopt grind (high-rho ALM re-polish,
        lorads_solver.c:1075-1117 + main.c:414-476) when it succeeds;
        the caller falls back to that grind when it doesn't.

        Returns True iff the refined dual was kept (admm_stats'
        dinf/dObj/gap updated to the re-measured values)."""
        p = self.params
        band = p.phase2_tol if p.high_acc_mode else 5 * p.phase2_tol
        # The spectral repair goes first: it targets the slack's
        # binding eigendirection directly, which the complementarity
        # LS below cannot see when that direction is orthogonal to
        # range(R) (the near-optimal case).
        if self._try_spectral_repair(admm_stats):
            return True
        t0 = time.time()
        Rbar = jax.tree.map(lambda u, v: 0.5 * (u + v), self.U, self.V)
        old_dual = self.dual
        old_dobj, old_gap = self.dobj, self.gap
        n_iter = min(max(2 * self.pd.m, 64), 1200)
        step, ls0, ls1 = dual_ls_refine(self.pd, Rbar, self.dual,
                                        n_iter)
        ls0, ls1 = jax.device_get((ls0, ls1))
        # b^T step = 0 by construction, so dObj/gap are unchanged by
        # ANY damping t — acceptance is a pure dinf comparison.  The
        # full LS step can still overshoot PSD-ness in directions
        # outside R's column space (||S R||_F doesn't see them), so
        # try damped candidates; each costs one certificate dispatch.
        # Repair must NOT compose during candidate evaluation: a
        # composed identity shift moves dObj (measured on theta n=300:
        # it dragged dObj 70 below pObj and masked the candidate's own
        # quality) — it is applied, if ever, to the accepted point by
        # the ordinary certificate path later.
        best_t, best_dinf = None, admm_stats.dinf_l1
        for t in (1.0, 0.25):
            self.dual = old_dual + t * step
            dinf_t = self.dual_infeasibility(repair=False)
            if dinf_t < best_dinf:
                best_t, best_dinf = t, dinf_t
            if dinf_t <= band:
                break
        accept = best_t is not None and best_dinf <= band
        self.log(f"dual refine: LS |S R| {float(ls0):.3e} -> "
                 f"{float(ls1):.3e} ({n_iter}-iter CGNR cap, "
                 f"b-orthogonal), dinf {admm_stats.dinf_l1:.2e} -> "
                 f"{best_dinf:.2e}"
                 + (f" at t={best_t}" if best_t is not None else "")
                 + f" [{time.time() - t0:.2f}s] -> "
                 f"{'accepted' if accept else 'rejected'}")
        if accept:
            self.dual = old_dual + best_t * step
            dobj_new = float(jnp.vdot(self.pd.rhs, self.dual))
            dobj_new /= self.scale_obj_his
            gap_new = abs(self.pobj - dobj_new) / (
                1.0 + abs(self.pobj) + abs(dobj_new))
            self.dobj = dobj_new
            self.gap = gap_new
            admm_stats.dobj = dobj_new
            admm_stats.gap = gap_new
            admm_stats.dinf_l1 = best_dinf
            admm_stats.dinf_inf = best_dinf * (1 + self.pd.c_nrm1) / (
                1 + self.pd.c_nrm_inf)
            return True
        self.dual = old_dual
        self.dobj, self.gap = old_dobj, old_gap
        return False

    def _repair_plan(self, lp_part, lams):
        """Build the dual-repair shift, or None when repairing cannot
        improve the acceptance outcome.  The shift trades a
        |lam_min|-sized dObj move for dinf ~ 0 on identity-direction
        blocks, which only helps when

        * dinf currently FAILS its band,
        * the REPAIRABLE violation mass is what's failing it (a
          violation living in blocks without identity directions
          cannot be fixed by any shift — don't burn a second
          certificate dispatch on noise shifts), and
        * the predicted post-shift gap still passes (or the gap was
          failing anyway).  Without this, repairing an
          already-certified Max-Cut (dinf 2e-7 hiding |lam_min| ~
          1e-2 behind the 1/(1+||C||_1) normalization) would move
          dObj by n * |lam_min| and destroy the gap.

        Lanczos Ritz values can only UNDER-estimate |lam_min|, so the
        shift carries a 5% margin; dinf is re-measured post-shift.
        """
        p = self.params
        band = p.phase2_tol if p.high_acc_mode else 5 * p.phase2_tol
        norm = self.scale_obj_his * (self.pd.c_nrm1 + 1.0)
        lams = [np.nan_to_num(np.asarray(lam), nan=-1.0)
                for lam in lams]
        pre = float(lp_part)
        for lam in lams:
            pre += float(np.sum(np.abs(np.minimum(lam, 0.0))))
        if pre / norm <= band:
            return None

        dirs = self._identity_directions()
        delta = np.zeros(self.pd.m, dtype=np.float64)
        repairable = 0.0
        floor = -1e-14 * max(1.0, float(self.pd.c_nrm_inf))
        for bk, bp, lam in zip(self.pd.buckets, self.ps.buckets, lams):
            b_eff = 1 if (bk.summed or bk.rowshard) else bk.B
            for b in range(b_eff):
                d = dirs[bp.plans[b].index]
                lam_b = float(lam[b])
                if d is None or lam_b >= floor:
                    continue
                slots, coefs = d
                delta[slots] += 1.05 * lam_b * coefs
                repairable += -lam_b
        # the violation left after a perfect repair must pass the band
        if repairable == 0.0 or (pre - repairable) / norm > band:
            return None

        dobj_cur = float(jnp.vdot(self.pd.rhs, self.dual))
        ddobj = float(np.dot(np.asarray(self.pd.rhs, np.float64),
                             delta))
        dobj_new = (dobj_cur + ddobj) / self.scale_obj_his
        gap_new = abs(self.pobj - dobj_new) / (
            1.0 + abs(self.pobj) + abs(dobj_new))
        gap_now = abs(self.pobj - dobj_cur / self.scale_obj_his) / (
            1.0 + abs(self.pobj) + abs(dobj_cur / self.scale_obj_his))
        # Never move the gap OUT of the status-classification band
        # (main.c:478-487 uses 5*tol regardless of high_acc_mode): in
        # high-acc the repair band is the tighter phase2_tol, and an
        # unconditional "gap was failing the repair band anyway"
        # waiver could take a solve that classifies PRIMAL_DUAL_OPTIMAL
        # (gap 3e-5 <= 5e-5) and shift it to MAXITER (gap 1e-3).
        cls_band = 5 * p.phase2_tol
        if (gap_new <= band
                or (gap_new <= cls_band and gap_now > band)
                or gap_now > cls_band):
            return delta
        return None

    def _bucket_plans(self, bk):
        for bp in self.ps.buckets:
            if bp.n == bk.n and bp.B == bk.B and bp.K == bk.K:
                return bp.plans
        raise KeyError("bucket not found")


    # ------------------------------------------------------------------
    # Reopt (lorads_solver.c:1075-1117).
    # ------------------------------------------------------------------

    def reopt(self, alm_stats: ALMStats, admm_stats: ADMMStats,
              reopt_param: float, reopt_alm_iter: int, reopt_admm_iter: int,
              time_solve_start: float, admm_bad_iter_flag: int,
              reopt_level: int) -> int:
        p = self.params
        max_alm = reopt_alm_iter - 1 + alm_stats.outer_iter
        old_rho_max = self.rho_max

        # scale objective & dual by reopt_param
        self.scale_obj_his *= reopt_param
        self.pd = aop.scale_objective(self.pd, reopt_param)
        self.dual = self.dual * reopt_param

        if admm_stats.rho <= self.rho_max:
            alm_stats.rho = max(admm_stats.rho, alm_stats.rho)

        self.alm_phase(alm_stats, time_solve_start, reopt=True,
                       early_stop=True,
                       rho_update_factor=math.sqrt(p.alm_rho_factor),
                       max_alm_iter=max_alm)
        self.rho_max = max(
            math.sqrt(max(admm_stats.rho, alm_stats.rho) / admm_stats.rho)
            * admm_stats.rho, self.rho_max)
        self.alm_to_admm(alm_stats, admm_stats)
        if admm_bad_iter_flag == 0 or reopt_level < 2:
            # reference: min(iter*4, iter + ORIGINAL maxADMMIter)
            # (lorads_solver.c:1098) — reopt_admm_iter only caps the
            # while-condition, which the celling dominates
            celling = min(admm_stats.iter * 4,
                          admm_stats.iter + p.max_admm_iter)
            st = self.admm_phase(admm_stats, celling, time_solve_start,
                                 reopt=True)
            admm_bad_iter_flag = 1 if st == "bad_iter" else 0
        self.rho_max = old_rho_max
        return admm_bad_iter_flag

    # ------------------------------------------------------------------
    # Full solve (main.c:321-487).
    # ------------------------------------------------------------------

    def solve(self) -> SolveResult:
        p = self.params
        t_start = time.time()
        alm_stats = ALMStats(rho=self.ps.rho0)
        admm_stats = ADMMStats(rho=self.ps.rho0)
        dual_infeas_time = 0.0
        admm_bad_iter_flag = 0
        status = SolverStatus.UNKNOWN

        self.log("Start solving by ALM and ADMM")
        action = self.alm_phase(alm_stats, t_start)
        if p.checkpoint_path:
            self.save(p.checkpoint_path, alm_stats, admm_stats, "post_alm")
        if action == "time_out" or time.time() - t_start > p.time_sec_limit:
            status = SolverStatus.TIME_LIMIT
        else:
            self.alm_to_admm(alm_stats, admm_stats)
            st = self.admm_phase(admm_stats, p.max_admm_iter, t_start)
            if p.checkpoint_path:
                self.save(p.checkpoint_path, alm_stats, admm_stats,
                          "post_admm")
            if st == "time_out":
                status = SolverStatus.TIME_LIMIT

        # reopt level 1 (main.c:376-398).  Escalation is deliberately
        # eager: the f64 level-1 polish drives dual infeasibility to ~0
        # as a side effect, so the (expensive) high-rho ALM work runs
        # once here instead of again at level 2.  (Lazy f32-first
        # escalation did worse on theta n=300: the f32 round fixes the
        # gap but leaves dinf at 1.7e-4, and the deferred f64 polish at
        # level 2 repeats the work.  Gating it on dual-repair coverage
        # did worse too: the f32 round leaves the gap at 4.5e-3 and the
        # deferred level-2 f64 rounds never close it — max_iter instead
        # of certified.)
        # Skip the level-1 gap-polish reopt when the gap continuation
        # already pushed the gap to its EMPIRICAL floor under continued
        # f64 iteration and that floor sits inside the classification
        # band (main.c:478-487 accepts gap <= 5 tol): the reopt's only
        # level-1 purpose is moving a gap that has just demonstrably
        # stopped moving.  dinf is still measured next, and level 2
        # runs the full reopt if it fails its band — nothing reported
        # is weakened.  high_acc_mode keeps strict reference behavior.
        skip_gap_reopt = (getattr(self, "_gap_push_stalled", False)
                          and not p.high_acc_mode
                          and admm_stats.gap <= 5 * p.phase2_tol
                          and admm_stats.pinf_l1 <= p.phase2_tol)
        if skip_gap_reopt:
            self.log("skipping level-1 reopt: gap plateaued at "
                     f"{admm_stats.gap:.2e} (within the 5*tol band) "
                     "under continued f64 ADMM")
        if (status is SolverStatus.UNKNOWN and p.reopt_level >= 1
                and not skip_gap_reopt):
            cnt = 0
            while ((alm_stats.gap > p.phase2_tol
                    or alm_stats.pinf_l1 > p.phase2_tol)
                   and (admm_stats.gap > p.phase2_tol
                        or admm_stats.pinf_l1 > p.phase2_tol)):
                self.maybe_escalate_f64("reopt needed at f32")
                if cnt >= 1:
                    break
                self.log("****** reopt parameter: 5.0")
                admm_budget = 1000 if p.high_acc_mode else 50
                admm_bad_iter_flag = self.reopt(
                    alm_stats, admm_stats, 5.0, 3, admm_budget, t_start,
                    admm_bad_iter_flag, 1)
                cnt += 1
                if time.time() - t_start > p.time_sec_limit:
                    status = SolverStatus.TIME_LIMIT
                    break

        t_di = time.time()
        dinf = self.dual_infeasibility(stats=admm_stats)
        dual_infeas_time += time.time() - t_di
        admm_stats.dinf_l1 = dinf
        admm_stats.dinf_inf = dinf * (1 + self.pd.c_nrm1) / (
            1 + self.pd.c_nrm_inf)
        self.log(f"Dual infeasibility: l_1 = {dinf:.6f}, "
                 f"l_inf = {admm_stats.dinf_inf:.6f}")

        # Direct dual refinement (extension): before conceding a
        # failing dinf to the level-2 reopt grind, fit the dual to
        # complementarity (one cheap CGNR dispatch) and keep it if the
        # re-measured outcome improves — the level-2 loop below then
        # sees passing bands and never runs.
        if (status is SolverStatus.UNKNOWN and p.dual_refine
                and self.pd.lp is None
                and admm_stats.dinf_l1 > (
                    p.phase2_tol if p.high_acc_mode
                    else 5 * p.phase2_tol)):
            t_di = time.time()
            self._try_dual_refine(admm_stats)
            dual_infeas_time += time.time() - t_di

        # reopt level 2 (main.c:414-476)
        if status is SolverStatus.UNKNOWN and p.reopt_level >= 2:
            dual_cnt = 0
            while (admm_stats.dinf_l1 > p.phase2_tol
                   or admm_stats.gap > p.phase2_tol
                   or admm_stats.pinf_l1 > p.phase2_tol):
                if dual_cnt >= 2:
                    break
                if (not p.high_acc_mode
                        and admm_stats.dinf_l1 <= 5 * p.phase2_tol
                        and admm_stats.gap <= 5 * p.phase2_tol
                        and admm_stats.pinf_l1 <= p.phase2_tol):
                    break
                self.maybe_escalate_f64("dual reopt needed at f32")
                self.log("****** reopt parameter: 5.0")
                admm_bad_iter_flag = self.reopt(
                    alm_stats, admm_stats, 5.0, 3, 50, t_start,
                    admm_bad_iter_flag, 2)
                # average U,V -> R; V <- R (main.c:438-448)
                self.R = jax.tree.map(lambda u, v: 0.5 * (u + v),
                                      self.U, self.V)
                self.V = self.R
                t_di = time.time()
                dinf = self.dual_infeasibility(stats=admm_stats)
                dual_infeas_time += time.time() - t_di
                admm_stats.dinf_l1 = dinf
                admm_stats.dinf_inf = dinf * (1 + self.pd.c_nrm1) / (
                    1 + self.pd.c_nrm_inf)
                self.log(f"reopt {dual_cnt}: dual infeasibility l_1 = "
                         f"{dinf:.6f}")
                dual_cnt += 1
                if time.time() - t_start > p.time_sec_limit:
                    status = SolverStatus.TIME_LIMIT
                    break

        # status classification (main.c:478-487)
        if status is SolverStatus.UNKNOWN:
            if (admm_stats.dinf_l1 <= 5 * p.phase2_tol
                    and admm_stats.gap <= 5 * p.phase2_tol
                    and admm_stats.pinf_l1 <= p.phase2_tol):
                status = SolverStatus.PRIMAL_DUAL_OPTIMAL
            elif (admm_stats.gap <= 5 * p.phase2_tol
                  and admm_stats.pinf_l1 <= p.phase2_tol):
                status = SolverStatus.PRIMAL_OPTIMAL
            else:
                status = SolverStatus.MAXITER

        Rbar = jax.tree.map(lambda u, v: 0.5 * (u + v), self.U, self.V)
        # self.R was last written at ALM exit (or the level-2 reopt
        # averaging); the certified DIMACS numbers above are for
        # X_bar = avg(U, V).  Align the solver's extraction surfaces
        # (x_blocks / factor_blocks / save_solution) with what was
        # just reported.
        self.R = Rbar
        pinf_inf = self.pinf_l1 * (1 + self.pd.b_nrm1) / (
            1 + self.pd.b_nrm_inf)
        return SolveResult(
            status=status, pobj=self.pobj, dobj=self.dobj,
            pinf_l1=self.pinf_l1, pinf_inf=pinf_inf,
            dinf_l1=admm_stats.dinf_l1, dinf_inf=admm_stats.dinf_inf,
            gap=self.gap, alm_stats=alm_stats, admm_stats=admm_stats,
            solve_time=time.time() - t_start,
            dual_infeas_time=dual_infeas_time, ranks=list(self.ranks),
            # the internal dual lives in reopt-SCALED units (the
            # objective is rescaled by 5 per reopt round); export the
            # user's dual point for the ORIGINAL problem
            R=Rbar, dual=np.asarray(self.dual) / self.scale_obj_his)


def solve(problem: SDPProblem, params: Optional[LoradsParams] = None,
          **kw) -> SolveResult:
    """One-call API: solve a standard-form SDP instance."""
    if params is None:
        params = LoradsParams(**kw)
    return LoradsSolver(problem, params).solve()


def _find_identity_direction(blk, shared):
    """Identity direction of one block for the dual repair (see
    LoradsSolver._identity_directions): returns (slots, coefs) with
    A*(coefs at slots) = I restricted to this block, or None.
    ``shared``: length-m bool mask of constraint rows touched by more
    than one owner (block or LP) — those slots are never usable.

    Two recognized shapes:
    * a trace-style constraint: one block-exclusive constraint whose
      entries are exactly the full diagonal at a constant value c
      (theta: tr X = 1) -> ([k], [1/c]);
    * a diagonal family: block-exclusive single-entry diagonal
      constraints a_i X_ii = b_i covering every row (Max-Cut)
      -> (k_0..k_{n-1}, 1/a_i).
    """
    if blk.a_con.size == 0:
        return None
    diag = blk.a_row == blk.a_col
    total_cnt = np.bincount(blk.a_con, minlength=blk.m)
    diag_cnt = np.bincount(blk.a_con[diag], minlength=blk.m)

    # (a) trace-style constraint
    cand = np.nonzero((total_cnt == blk.dim)
                      & (diag_cnt == blk.dim))[0]
    if cand.size:
        cand = cand[~shared[cand]]
    for k in cand:
        sel = blk.a_con == k
        rows = blk.a_row[sel]
        vals = blk.a_val[sel]
        if (np.unique(rows).size == blk.dim and vals[0] != 0.0
                and np.allclose(vals, vals[0])):
            return (np.asarray([k], dtype=np.int64),
                    np.asarray([1.0 / vals[0]]))

    # (b) single-entry diagonal family covering every row
    ks = np.nonzero((total_cnt == 1) & (diag_cnt == 1))[0]
    if ks.size:
        ks = ks[~shared[ks]]
    if ks.size:
        sel = np.isin(blk.a_con, ks)
        rows = blk.a_row[sel]
        cons = blk.a_con[sel]
        vals = blk.a_val[sel]
        ok = vals != 0.0
        rows, cons, vals = rows[ok], cons[ok], vals[ok]
        # first constraint per row
        order = np.argsort(rows, kind="stable")
        rows, cons, vals = rows[order], cons[order], vals[order]
        first = np.concatenate([[True], rows[1:] != rows[:-1]])
        rows, cons, vals = rows[first], cons[first], vals[first]
        if rows.size == blk.dim and np.array_equal(
                rows, np.arange(blk.dim)):
            return (cons.astype(np.int64), 1.0 / vals)
    return None


# Slack blocks up to this dim get an exact eigh certificate instead of
# the Lanczos sweep (see _dual_infeas_device).  Covers the theta family
# (n=300/800 dense blocks), whose clustered spectra a restarted Lanczos
# resolves slowly; round 2 extends the rescue from dense-only to
# sparse-mode blocks (densify_w) under a total-size budget.
_DENSE_EIG_DIM = 1024
# cap B * n^2 for the densified [B, n, n] slack (2^26 f64 = 512 MB)
_DENSE_EIG_BUDGET = 2 ** 26


# How many smallest eigenpairs the eigh-rescue certificate hands the
# spectral dual repair per block (the eigh computes them all anyway;
# more directions per round = fewer certificate round trips — theta's
# slack spectrum is DENSE near zero, so discovery rate is what bounds
# the repair's convergence).
_EIG_K = 12


def _exact_min_eig(Wn):
    """Exact smallest eigenpairs of normalized slack blocks [B, n, n]
    -> (lams [B, k], vecs [B, k, n]), k = min(_EIG_K, n), ascending.
    lams[:, 0] is the certificate value; the extra pairs feed the
    spectral dual repair (solver._try_spectral_repair).  One batched
    eigh at the operator's dtype."""
    k = min(_EIG_K, Wn.shape[-1])
    evals, vecs = jnp.linalg.eigh(Wn)
    return evals[:, :k], jnp.swapaxes(vecs[:, :, :k], 1, 2)


def _eig_rescue_ok(bk) -> bool:
    """Small slack blocks (dense OR sparse-mode) get the exact eigh."""
    return (not bk.summed and not bk.rowshard
            and bk.n <= _DENSE_EIG_DIM
            and bk.B * bk.n * bk.n <= _DENSE_EIG_BUDGET)


def _slack_operator(bk, w_loc):
    """Normalized slack operator S/ws = (C - A^*(lambda))/ws for one
    bucket, shared by the jitted certificate and the profiling tools
    (tools/profile_cert.py drives per-restart Ritz trajectories on the
    exact production operator).

    Returns (kind, op, ws_eff):
      kind "eigh":    op is the normalized dense slack [B, n, n]
                      (exact-eigh rescue path)
      kind "lanczos": op is the [B, n] -> [B, n] matvec closure
    ws_eff rescales the normalized eigenvalues back.
    """
    if (bk.split and bk.diag_ident and not bk.summed
            and not _eig_rescue_ok(bk)):
        # A^*(lambda) is diagonal, so the slack's off part is the
        # STATIC C pattern: mv = one single-pass cmul + elementwise
        # diagonal (same trick as the ALM fast path)
        W_d = bk.c_diag + bk.a_val_d * w_loc
        ws = jnp.maximum(jnp.maximum(
            jnp.max(jnp.abs(W_d), axis=1),
            jnp.max(jnp.abs(bk.c_off), axis=1)), 1e-30)
        Wdn = W_d / ws[:, None]
        inv = 1.0 / ws

        def mv(x, bk=bk, Wdn=Wdn, inv=inv):
            off = pat.cmul(bk, x[:, :, None],
                           include_diag=False)[:, :, 0]
            return off * inv[:, None] + Wdn * x

        return "lanczos", mv, ws
    if bk.rowshard:
        # slack row slabs [D, n_loc, n]; mv is the row-sharded
        # dsymm — one logical cone, normalize by the global max
        W = pat.build_w(bk, w_loc)
        ws = jnp.maximum(jnp.max(jnp.abs(W)), 1e-30)
        Wn = W / ws

        def mv(x, bk=bk, Wn=Wn):
            return pat.w_mul(bk, Wn, x[:, :, None])[:, :, 0]

        return "lanczos", mv, ws
    W = pat.build_w(bk, w_loc)
    # normalize the slack operator per block: |lambda| grows with
    # rho, and an un-normalized f32 Lanczos sweep can overflow
    # (eigenvalues rescale back exactly)
    if bk.dense:
        ws = jnp.maximum(jnp.max(jnp.abs(W), axis=(1, 2)), 1e-30)
        Wn = W / ws[:, None, None]
        if _eig_rescue_ok(bk):
            # small dense slack: exact min eigenvalue by full eigh
            # (a bounded Lanczos under-estimates |lam_min| on
            # clustered small-block spectra; exact here is one
            # cheap [B, n, n] eigh; theta800 certifies with it at
            # dinf 3.0e-6).
            return "eigh", Wn, ws
    elif bk.split:
        W_d, W_o, W_oc = W
        ws = jnp.maximum(jnp.maximum(
            jnp.max(jnp.abs(W_d), axis=1),
            jnp.max(jnp.abs(W_o), axis=1)), 1e-30)
        if bk.summed:
            # one logical cone: normalize by the global max so
            # every shard rescales identically
            ws = jnp.broadcast_to(jnp.max(ws), ws.shape)
        Wn = (W_d / ws[:, None], W_o / ws[:, None],
              W_oc / ws[:, None])
    else:
        ws = jnp.maximum(jnp.max(jnp.abs(W), axis=1), 1e-30)
        if bk.summed:
            ws = jnp.broadcast_to(jnp.max(ws), ws.shape)
        Wn = W / ws[:, None]

    if not bk.dense and _eig_rescue_ok(bk):
        # small SPARSE-mode slack: same exact eigh as the dense
        # rescue, on the densified normalized operator (round-2
        # extension; the bounded Lanczos can under-report
        # clustered-spectrum sparse blocks the same way)
        return "eigh", pat.densify_w(bk, Wn), ws

    def mv(x, bk=bk, Wn=Wn):
        return pat.w_mul(bk, Wn, x[:, :, None])[:, :, 0]

    return "lanczos", mv, (ws[:1] if bk.summed else ws)


@jax.jit
def _dual_infeas_device(pd, dual, v0s):
    """Slack assembly + normalized batched Lanczos for every bucket +
    the LP column part, as one device program.

    Reference: calculate_dual_infeasibility_solver + dual_infeasible
    (lorads_solver.c:1007-1037, lorads_sdp_conic.c:1286-1349; ARPACK
    "SA", ncv=40, tol=1e-2 becomes a 36-step adaptive-restart batched
    Lanczos with on-device tridiagonal eigh).  Also returns each
    Lanczos bucket's restart count (cost observability, -1 for exact
    eigh buckets).
    """

    neg_l = -dual
    if pd.lp is not None:
        vals = pd.lp.obj + lp_ops.adjoint_cols(pd.lp, neg_l)
        lp_part = jnp.sum(jnp.abs(jnp.minimum(vals, 0.0)))
    else:
        lp_part = jnp.zeros((), dual.dtype)
    hi = dual.dtype == jnp.float64
    lams = []
    restarts = []
    vecs = []
    lams_k = []
    for bk, v0 in zip(pd.buckets, v0s):
        w_loc = pat.gather_w(bk, neg_l)
        kind, op, ws_eff = _slack_operator(bk, w_loc)
        if kind == "eigh":
            lk, vk = _exact_min_eig(op)
            lk = lk.astype(dual.dtype) * ws_eff[:, None]
            lams.append(jnp.min(lk, axis=1))
            restarts.append(jnp.asarray(-1, jnp.int32))
            vecs.append(vk.astype(dual.dtype))
            lams_k.append(lk)
        elif hi:
            # f64-escalated solve: run the Lanczos restart loop at f32
            # on an f32 cast of the SAME normalized slack (eigenvectors
            # only need f32 accuracy) and refine the final eigenvalue
            # by one Rayleigh quotient against the f64 operator — no
            # sweep matvec runs at f64.  ARPACK's own tol
            # is 1e-2 (lorads_sdp_conic.c:1306); the f64 refinement
            # squares the f32 angle error, so the reported eigenvalue
            # is far INSIDE that band.
            _, op32, _ = _slack_operator(pat.cast_floats(bk),
                                         w_loc.astype(jnp.float32))
            lam, its, vec = lanczos_min_eig_device(
                op32, v0.astype(jnp.float32), matvec_hi=op,
                return_vec=True)
            lam = lam * ws_eff
            lams.append(lam)
            restarts.append(its)
            vecs.append(vec.astype(dual.dtype)[:, None, :])
            lams_k.append(lam[:, None])
        else:
            lam, its, vec = lanczos_min_eig_device(op, v0,
                                                   return_vec=True)
            lam = lam * ws_eff
            lams.append(lam)
            restarts.append(its)
            vecs.append(vec[:, None, :])
            lams_k.append(lam[:, None])
    return (lp_part, tuple(lams), tuple(restarts), tuple(vecs),
            tuple(lams_k))
