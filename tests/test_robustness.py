"""Regression tests for the round-2 robustness mechanisms
(docs/DESIGN.md #19a/#19c): CG no-progress stop, preemptive f32->f64
escalation, ADMM gap continuation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lorads_tpu import LoradsParams
from lorads_tpu.alg.cg import cg_solve
from lorads_tpu.alg.solver import ADMMStats, ALMStats, LoradsSolver
from lorads_tpu.io import generators


def test_cg_no_progress_stop_bounds_iterations():
    """An unreachable tol must not burn the full iteration cap: the
    no-progress exit stops each block at ITS residual floor (the
    matcomp2000 pathology: tol ~1e-11 at f32 -> 800 iters per solve,
    71k CG iters per 87 ADMM iters, worker-killing dispatches)."""
    rng = np.random.default_rng(0)
    n, r = 64, 4
    # moderately ill-conditioned SPD operator, f32
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * np.geomspace(1.0, 1e4, n)) @ Q.T
    A32 = jnp.asarray(A, jnp.float32)
    op = lambda x: jnp.einsum("ij,bjr->bir", A32, x)
    b = jnp.asarray(rng.standard_normal((1, n, r)), jnp.float32)
    x0 = jnp.zeros_like(b)

    x_strict, k_strict = cg_solve(op, x0, b, 1e-14, 800)
    # cond number 1e4: convergence needs ~300-400 iters, the floor is
    # reached soon after -- well short of the 800 cap
    assert int(k_strict) < 600, "no-progress stop did not engage"
    # the early-stopped solution is as good as f32 allows: residual
    # within 10x of a reference tol=1e-8 solve
    x_ref, _ = cg_solve(op, x0, b, 1e-8, 800)
    res = lambda x: float(jnp.linalg.norm(b - op(x)))
    assert res(x_strict) <= 10 * max(res(x_ref), 1e-6)


def test_preemptive_f64_escalation_on_tight_pinf_target():
    """When the ADMM exit's implied pinf_l1 target sits below the f32
    floor (tol (1+binf)/(1+b1) < 5e-10), dtype=auto must enter the
    phase at f64 instead of burning f32 iterations (DESIGN.md #19c;
    measured 41 s of waste on matcomp2000)."""
    problem = generators.matrix_completion(n1=60, n2=60, true_rank=3,
                                           frac_obs=0.3, seed=0)
    # shrink tol until the target crosses the threshold for this b
    # CPU auto-dtype resolves straight to f64, so force the f32 start
    # and re-enable auto escalation (the accelerator auto path's state)
    s = LoradsSolver(problem, LoradsParams(verbose=False, dtype="f32",
                                           phase2_tol=1e-9))
    s._auto_dtype = True
    need = 1e-9 * (1 + float(s.pd.b_nrm_inf)) / (1 + float(s.pd.b_nrm1))
    assert need < 5e-10, "test instance lost its premise"
    assert s.dtype == jnp.float32
    stats = ADMMStats(rho=s.ps.rho0)
    stats.gap = 1.0
    stats.pinf_l1 = 1.0
    s.admm_phase(stats, 1, __import__("time").time())
    assert s.dtype == jnp.float64, "preemptive escalation did not fire"


def test_gap_continuation_improves_final_gap():
    """A solve whose ADMM exits on pinf with gap in (tol, 5tol] pushes
    the gap down under the continuation instead of conceding to reopt
    (which the control run must then take to pass the bands)."""
    problem = generators.random_multiblock(n_blocks=3, dim=15, m=12,
                                           n_lp=4, seed=2)
    on = LoradsSolver(problem, LoradsParams(
        verbose=False, admm_gap_continue=True)).solve()
    off = LoradsSolver(problem, LoradsParams(
        verbose=False, admm_gap_continue=False)).solve()
    assert on.status.value == "primal_dual_optimal"
    assert off.status.value == "primal_dual_optimal"
    assert on.pinf_l1 <= 1e-5
    # the continuation must not leave the gap worse than the
    # reopt-based control beyond the strict tolerance itself
    assert on.gap <= max(off.gap, 1e-5) * 1.5


def test_f32_admm_divergence_is_caught():
    """At f32 a splitting entered below its stable rho overflows to NaN
    before the pinf/gap thresholds trip (NaN compares False, and
    1 - 1e-8 rounds to 1.0 at f32): the non-finite guard must hand it
    to the divergence recovery (retry at 5x rho) instead of iterating
    NaNs to the cap.  Instance: blocks of two sizes plus an LP block
    sharing one constraint set (chip_smoke.py's multi-block case)."""
    from lorads_tpu.core.problem import SDPProblem

    a = generators.random_multiblock(n_blocks=3, dim=40, m=60, seed=11)
    b = generators.random_multiblock(n_blocks=2, dim=90, m=60, n_lp=8,
                                     seed=12)
    problem = SDPProblem(m=60, rhs=a.rhs + b.rhs,
                         blocks=a.blocks + b.blocks, lp=b.lp)
    res = LoradsSolver(problem, LoradsParams(
        verbose=False, dtype="f32", max_admm_iter=500)).solve()
    assert np.isfinite(res.pobj)
    assert res.status.value == "primal_dual_optimal"
