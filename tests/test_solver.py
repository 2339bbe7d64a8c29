"""End-to-end solver tests on small instances (CPU, f64).

Acceptance mirrors the reference's de-facto test: self-reported DIMACS
errors at termination within the OPTIMAL bands
(/root/reference/src_semi/main.c:478-487).
"""

import numpy as np
import pytest

from lorads_tpu import LoradsParams
from lorads_tpu.alg.solver import LoradsSolver
from lorads_tpu.config import SolverStatus
from lorads_tpu.io import generators


def _solve(problem, **kw):
    kw.setdefault("verbose", False)
    kw.setdefault("time_sec_limit", 300.0)
    params = LoradsParams(**kw)
    return LoradsSolver(problem, params).solve()


def _oracle_pobj(problem, res):
    """<C, X> from the returned factors (dense oracle)."""
    total = 0.0
    k = 0
    # reconstruct bucket layout to map factors back to blocks
    from lorads_tpu.core.presolve import presolve
    ps = presolve(problem, LoradsParams())
    for bi, bp in enumerate(ps.buckets):
        Rb = np.asarray(res.R.cones[bi])
        for b, plan in enumerate(bp.plans):
            blk = problem.blocks[plan.index]
            R = Rb[b][: blk.dim]
            X = R @ R.T
            total += np.sum(blk.dense_obj() * X)
    if problem.lp is not None:
        x = np.asarray(res.R.lp) ** 2
        total += problem.lp.obj @ x
    return total


def test_maxcut_small_to_optimal():
    problem = generators.maxcut(n=50, avg_degree=5, seed=3)
    res = _solve(problem)
    assert res.status in (SolverStatus.PRIMAL_DUAL_OPTIMAL,
                          SolverStatus.PRIMAL_OPTIMAL)
    assert res.pinf_l1 <= 1e-5
    assert res.gap <= 5e-5
    # objective consistent with the dense oracle at the final factors
    assert res.pobj == pytest.approx(_oracle_pobj(problem, res), rel=1e-4,
                                     abs=1e-4)


def test_maxcut_matches_cvx_free_bound():
    # SDP relaxation objective must lower-bound ... we check primal
    # feasibility instead: diag(X)=1 at the solution.
    problem = generators.maxcut(n=40, avg_degree=4, seed=1)
    res = _solve(problem)
    from lorads_tpu.core.presolve import presolve
    R = np.asarray(res.R.cones[0])[0][:40]
    X = R @ R.T
    np.testing.assert_allclose(np.diag(X), 1.0, atol=1e-4)


def test_multiblock_with_lp():
    problem = generators.random_multiblock(n_blocks=3, dim=12, m=10,
                                           n_lp=6, seed=2)
    res = _solve(problem)
    assert res.pinf_l1 <= 1e-4
    assert res.gap <= 1e-3
    # LP part stays elementwise nonnegative: x = u*v with u == v at X_bar
    x = np.asarray(res.R.lp) ** 2
    assert np.all(x >= -1e-12)


def test_matrix_completion():
    problem = generators.matrix_completion(n1=20, n2=20, true_rank=2,
                                           frac_obs=0.5, seed=4)
    res = _solve(problem)
    assert res.pinf_l1 <= 1e-5
    assert res.gap <= 5e-4


def test_lovasz_theta():
    problem = generators.lovasz_theta(n=25, avg_degree=6, seed=5)
    res = _solve(problem)
    assert res.pinf_l1 <= 1e-4
    assert res.gap <= 1e-3


def test_admm_mixed_cg_matches_exact_f64():
    """Mixed-precision IR-CG (admm_mixed_cg, VERDICT r2 #1) must reach
    the same acceptance outcome as exact all-f64 CG on an f64 solve
    whose ADMM phase exercises the CG path (matcomp: dense-mode cone,
    no closed form)."""
    problem = generators.matrix_completion(n1=40, n2=40, true_rank=2,
                                           frac_obs=0.3, seed=9)
    res_mix = _solve(problem, dtype="f64", admm_mixed_cg=True)
    res_ref = _solve(problem, dtype="f64", admm_mixed_cg=False)
    for res in (res_mix, res_ref):
        assert res.pinf_l1 <= 1e-5
        assert res.gap <= 5e-5
    assert res_mix.status == res_ref.status
    assert res_mix.pobj == pytest.approx(res_ref.pobj, rel=1e-5,
                                         abs=1e-6)


def test_ungrouped_buckets_match_grouped():
    """Bucketing (vmap grouping) must not change the solution class."""
    problem = generators.random_multiblock(n_blocks=4, dim=10, m=8, seed=6)
    params = LoradsParams(verbose=False)
    r1 = LoradsSolver(problem, params, group_buckets=True).solve()
    r2 = LoradsSolver(problem, params, group_buckets=False).solve()
    assert r1.pobj == pytest.approx(r2.pobj, rel=5e-3, abs=5e-3)


def test_auto_jacobi_on_disjoint_blocks_matches_gs():
    """Merged instances (disjoint constraint sets) auto-enable the
    vectorized Jacobi sweep, which must equal the Gauss-Seidel sweep
    exactly there (no block reads another's constraint slots)."""
    import jax.numpy as jnp
    from lorads_tpu.alg import admm as admm_mod
    from lorads_tpu.core.problem import merge_problems
    from lorads_tpu.ops import pattern as pat

    probs = [generators.random_multiblock(n_blocks=1, dim=24, m=14,
                                          density=0.4, seed=s)
             for s in (1, 2)]
    merged = merge_problems(probs)
    solver = LoradsSolver(merged, LoradsParams(verbose=False))
    assert solver._bucket_jacobi == (True,)
    pd = solver.pd
    assert len(pd.buckets) == 1 and pd.buckets[0].B == 2

    rng = np.random.default_rng(3)
    bk = pd.buckets[0]
    shape = solver.U.cones[0].shape
    U = type(solver.U)((jnp.asarray(rng.standard_normal(shape)),),
                       solver.U.lp)
    V = type(solver.V)((jnp.asarray(rng.standard_normal(shape)),),
                       solver.V.lp)
    vals = pat.constr_vals(bk, pat.uvt(bk, U.cones[0], V.cones[0]))
    total = pat.scatter_constr(bk, vals)
    dual = jnp.asarray(rng.standard_normal(merged.m))
    rho = jnp.asarray(2.0, pd.rhs.dtype)
    args = (pd, U, V, (vals,), jnp.zeros_like(total), total, dual,
            rho, 1e-12, 500)
    out_j = admm_mod.admm_update_all(*args, jacobi=(True,))
    out_g = admm_mod.admm_update_all(*args, jacobi=False)
    np.testing.assert_allclose(np.asarray(out_j[0].cones[0]),
                               np.asarray(out_g[0].cones[0]),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(out_j[1].cones[0]),
                               np.asarray(out_g[1].cones[0]),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(out_j[4]),
                               np.asarray(out_g[4]), atol=1e-8)

    # coupled blocks (shared constraints) must stay Gauss-Seidel
    coupled = generators.random_multiblock(n_blocks=2, dim=24, m=14,
                                           density=0.4, seed=4)
    s2 = LoradsSolver(coupled, LoradsParams(verbose=False))
    assert not any(s2._bucket_jacobi)


def test_deterministic_given_seed():
    problem = generators.maxcut(n=30, avg_degree=4, seed=9)
    r1 = _solve(problem, seed=925)
    r2 = _solve(problem, seed=925)
    assert r1.pobj == r2.pobj
    assert r1.pinf_l1 == r2.pinf_l1


def test_solution_output(tmp_path):
    """--solOut factors reproduce a feasible X with the reported
    objective, and the dual vector y is saved alongside."""
    from lorads_tpu.__main__ import main
    from lorads_tpu.io.sdpa import write_sdpa

    problem = generators.random_multiblock(n_blocks=2, dim=12, m=8,
                                           n_lp=4, seed=7)
    f = tmp_path / "p.dat-s"
    write_sdpa(str(f), problem)
    sol = tmp_path / "sol.npz"
    assert main([str(f), "--quiet", "--solOut", str(sol)]) == 0
    data = np.load(sol)
    assert data["y"].shape == (problem.m,)

    # rebuild X from factors; check A(X) = b and <C, X> = pobj
    ax = np.zeros(problem.m)
    obj = 0.0
    for i, blk in enumerate(problem.blocks):
        F = data[f"f{i}"]
        X = F @ F.T
        obj += float(np.sum(blk.dense_obj() * X))
        for k in range(problem.m):
            ax[k] += float(np.sum(blk.dense_constr(k) * X))
    lp = data["lp"]
    obj += float(problem.lp.obj @ lp)
    for k, col, v in zip(problem.lp.a_con, problem.lp.a_col,
                         problem.lp.a_val):
        ax[k] += v * lp[col]
    np.testing.assert_allclose(ax, problem.rhs, atol=5e-4)
    res = LoradsSolver(problem, LoradsParams(verbose=False)).solve()
    assert obj == pytest.approx(res.pobj, rel=1e-3, abs=1e-3)


def test_extraction_matches_reported_objective_after_admm():
    """x_blocks/factor_blocks must reproduce the REPORTED pobj after a
    solve where ADMM does the work (regression: they used to return
    the stale ALM-exit factors)."""
    problem = generators.maxcut(n=200, avg_degree=4, seed=6)
    # loose phase-1 tolerance -> ALM hands off early, ADMM finishes
    res = _solve(problem, phase1_tol=0.5)
    assert res.pinf_l1 <= 1e-5
    s = LoradsSolver(problem, LoradsParams(verbose=False,
                                           phase1_tol=0.5))
    res2 = s.solve()
    xs, _ = s.x_blocks()
    obj = float(np.sum(problem.blocks[0].dense_obj() * xs[0]))
    assert obj == pytest.approx(res2.pobj, rel=1e-6, abs=1e-6)
    fs, _ = s.factor_blocks()
    obj_f = float(np.sum(problem.blocks[0].dense_obj()
                         * (fs[0] @ fs[0].T)))
    assert obj_f == pytest.approx(res2.pobj, rel=1e-6, abs=1e-6)


def test_warm_start_from_factors():
    """set_initial_factors seeds a re-solve that converges in fewer
    ALM iterations than the cold solve (and to the same objective)."""
    problem = generators.maxcut(n=200, avg_degree=4, seed=8)
    params = LoradsParams(verbose=False)
    cold = LoradsSolver(problem, params)
    res_cold = cold.solve()
    fs, lp_vals = cold.factor_blocks()

    warm = LoradsSolver(problem, params)
    warm.set_initial_factors(fs, lp_vals, dual=res_cold.dual)
    res_warm = warm.solve()
    assert res_warm.pinf_l1 <= 1e-5
    assert res_warm.pobj == pytest.approx(res_cold.pobj, rel=1e-5,
                                          abs=1e-4)
    assert (res_warm.alm_stats.inner_iter
            < 0.5 * res_cold.alm_stats.inner_iter)

    # perturbed re-solve: small weight noise, warm start still helps
    import dataclasses as _dc
    blk = problem.blocks[0]
    rng = np.random.default_rng(0)
    blk2 = _dc.replace(blk, obj_val=blk.obj_val
                       * (1.0 + 0.01 * rng.standard_normal(
                           blk.obj_val.shape)))
    problem2 = _dc.replace(problem, blocks=[blk2])
    warm2 = LoradsSolver(problem2, params)
    warm2.set_initial_factors(fs, lp_vals, dual=res_cold.dual)
    res2 = warm2.solve()
    assert res2.pinf_l1 <= 1e-5
    assert (res2.alm_stats.inner_iter
            < 0.8 * res_cold.alm_stats.inner_iter)


def test_lp_only_problem():
    """A problem with ONLY the LP (diagonal) block and no SDP cones:
    min x0 + 2 x1 s.t. x0 + x1 = 1, x >= 0 -> opt 1 at (1, 0)."""
    from lorads_tpu.core.problem import LPBlockData, SDPProblem

    lp = LPBlockData(n_cols=2, m=1, obj=np.array([1.0, 2.0]),
                     a_con=np.array([0, 0], dtype=np.int32),
                     a_col=np.array([0, 1], dtype=np.int32),
                     a_val=np.array([1.0, 1.0]))
    problem = SDPProblem(m=1, rhs=np.array([1.0]), blocks=[], lp=lp)
    res = _solve(problem)
    assert res.pinf_l1 <= 1e-5
    assert res.pobj == pytest.approx(1.0, abs=1e-4)


def test_infeasible_problem_terminates_gracefully():
    """Contradictory constraints (X_00 = 1 and X_00 = 2) must end in a
    non-optimal status with honestly-large pinf — no hang, no crash
    (reference behavior: MAXITER with unmet tolerance)."""
    from lorads_tpu.core.problem import SDPBlockData, SDPProblem

    blk = SDPBlockData(
        dim=4, m=2,
        obj_row=np.array([0], dtype=np.int32),
        obj_col=np.array([0], dtype=np.int32),
        obj_val=np.array([1.0]),
        a_con=np.array([0, 1], dtype=np.int32),
        a_row=np.array([0, 0], dtype=np.int32),
        a_col=np.array([0, 0], dtype=np.int32),
        a_val=np.array([1.0, 1.0]))
    problem = SDPProblem(m=2, rhs=np.array([1.0, 2.0]), blocks=[blk])
    res = _solve(problem, time_sec_limit=120.0)
    assert res.status in (SolverStatus.MAXITER,
                          SolverStatus.TIME_LIMIT)
    assert res.pinf_l1 > 1e-2  # the violation is reported, not hidden


def test_checkpoint_roundtrip(tmp_path):
    """State saved mid-solve restores bit-exactly and resumes."""
    import jax.numpy as jnp

    problem = generators.maxcut(n=30, avg_degree=4, seed=9)
    params = LoradsParams(verbose=False)
    s1 = LoradsSolver(problem, params)
    res1 = s1.solve()
    path = str(tmp_path / "ckpt.npz")
    s1.save(path, phase="final")

    s2 = LoradsSolver(problem, LoradsParams(verbose=False))
    meta = s2.load(path)
    assert meta["phase"] == "final"
    assert s2.ranks == s1.ranks
    np.testing.assert_array_equal(np.asarray(s2.dual),
                                  np.asarray(s1.dual))
    for a, b in zip(s2.U.cones, s1.U.cones):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert s2.scale_obj_his == s1.scale_obj_his


def test_jacobi_bucket_mode():
    """admm_jacobi=True (sharded-execution mode) still converges on a
    weakly coupled multi-block instance."""
    problem = generators.random_multiblock(n_blocks=4, dim=10, m=8,
                                           seed=6)
    res = _solve(problem, admm_jacobi=True)
    assert res.pinf_l1 <= 1e-4
    assert res.gap <= 1e-3


def test_maxcut_f32_path():
    """The f32 start of dtype="auto" on accelerators converges on CPU too."""
    problem = generators.maxcut(n=100, avg_degree=6, seed=21)
    res = _solve(problem, dtype="f32")
    assert res.status in (SolverStatus.PRIMAL_DUAL_OPTIMAL,
                          SolverStatus.PRIMAL_OPTIMAL)
    assert res.pinf_l1 <= 1e-5


def test_rank_augmentation_bookkeeping():
    """aug_rank grows factor buffers with scaled-identity columns and
    the solve still converges afterwards (AUG_RANK,
    lorads_solver.c:806-906)."""
    problem = generators.maxcut(n=60, avg_degree=5, seed=3)
    params = LoradsParams(verbose=False)
    s = LoradsSolver(problem, params)
    r0 = s.ranks[0]
    rm = s.rank_maxes[0]
    assert not s.is_rank_max()
    s.aug_rank(1.5)
    assert s.ranks[0] == min(int(np.ceil(r0 * 1.5)), rm)
    B, n, r = s.R.cones[0].shape
    assert r == s.ranks[0]
    # new columns are the scaled identity (lpRandomDiag semantics)
    newcols = np.asarray(s.R.cones[0][0][:, r0:])
    aug = r - r0
    expect = np.eye(n, aug) / np.sqrt(min(n, aug))
    np.testing.assert_allclose(newcols, expect)
    res = s.solve()
    assert res.pinf_l1 <= 1e-5


def test_dyrank_level_thresholds():
    """rank_flag_thres keyed on dyrankLevel (lorads_alm.c:1022-1031)."""
    for lvl, thres in [(0, 1e8), (1, 150.0), (2, 15.0), (3, 5.0)]:
        assert LoradsParams(dyrank_level=lvl).rank_flag_thres == thres


def test_single_constraint_problem():
    """Degenerate bounded m=1 instance (min tr X s.t. X_00 = 1)
    solves without shape bugs; optimum is X = e1 e1^T, pObj = 1."""
    from lorads_tpu.core.problem import SDPBlockData, SDPProblem
    n = 6
    blk = SDPBlockData(
        dim=n, m=1,
        obj_row=np.arange(n, dtype=np.int32),
        obj_col=np.arange(n, dtype=np.int32),
        obj_val=np.ones(n),
        a_con=np.zeros(1, np.int32),
        a_row=np.zeros(1, np.int32),
        a_col=np.zeros(1, np.int32),
        a_val=np.ones(1))
    problem = SDPProblem(m=1, rhs=np.ones(1), blocks=[blk])
    res = _solve(problem)
    assert res.pinf_l1 <= 1e-5
    assert res.pobj == pytest.approx(1.0, abs=1e-3)


def test_dual_uv_variant():
    """DUAL_U_V build variant (+/-S ADMM terms, reference
    lorads_admm.c:483-591) solves to the same tolerances."""
    from lorads_tpu.io import generators
    problem = generators.random_multiblock(n_blocks=2, dim=15, m=12,
                                           n_lp=4, seed=9)
    res = LoradsSolver(problem, LoradsParams(verbose=False,
                                             dual_uv=True)).solve()
    assert res.status in (SolverStatus.PRIMAL_DUAL_OPTIMAL,
                          SolverStatus.PRIMAL_OPTIMAL)
    assert res.pinf_l1 <= 1e-5


def test_lbfgs_length_auto_by_structure():
    """None -> 4 when a large dense-mode block is present (theta
    shape; round-4 re-measurement, see LoradsParams), else 3;
    explicit value always wins (reference flag semantics)."""
    from lorads_tpu import LoradsParams
    from lorads_tpu.alg.solver import LoradsSolver
    from lorads_tpu.io import generators
    mc = generators.maxcut(n=100, avg_degree=5, seed=1)
    th = generators.lovasz_theta(n=60, avg_degree=5, seed=1)
    assert LoradsSolver(mc, LoradsParams(verbose=False)).lbfgs_len == 3
    assert LoradsSolver(th, LoradsParams(verbose=False)).lbfgs_len == 4
    assert LoradsSolver(
        th, LoradsParams(verbose=False, lbfgs_list_length=5)).lbfgs_len == 5


def _random_bounded_problem(seed):
    """Random mixed instance: 1-3 blocks of random dim (down to 1),
    ragged constraint coverage, optional LP block, plus a per-block
    trace constraint for boundedness; rhs from a random interior
    PSD point so the instance is feasible."""
    import numpy as np

    from lorads_tpu.core.problem import (LPBlockData, SDPBlockData,
                                         SDPProblem)

    r = np.random.default_rng(seed)
    nb = int(r.integers(1, 4))
    m_rand = int(r.integers(1, 15))
    m = m_rand + nb
    blocks, X_point = [], []
    for bi in range(nb):
        dim = int(r.integers(1, 24))
        tri_r, tri_c = np.tril_indices(dim)
        no = int(r.integers(0, tri_r.size)) + 1
        oi = r.choice(tri_r.size, size=no, replace=False)
        a_con, a_row, a_col, a_val = [], [], [], []
        for i in range(m_rand):
            if r.random() < 0.25:
                continue
            ne = int(r.integers(1, min(6, tri_r.size) + 1))
            ei = r.choice(tri_r.size, size=ne, replace=False)
            a_con += [i] * ne
            a_row += list(tri_r[ei])
            a_col += list(tri_c[ei])
            a_val += list(r.standard_normal(ne))
        a_con += [m_rand + bi] * dim
        a_row += list(range(dim))
        a_col += list(range(dim))
        a_val += [1.0] * dim
        blocks.append(SDPBlockData(
            dim=dim, m=m,
            obj_row=tri_r[oi].astype(np.int32),
            obj_col=tri_c[oi].astype(np.int32),
            obj_val=r.standard_normal(no),
            a_con=np.asarray(a_con, np.int32),
            a_row=np.asarray(a_row, np.int32),
            a_col=np.asarray(a_col, np.int32),
            a_val=np.asarray(a_val)))
        G = r.standard_normal((dim, dim))
        X_point.append(G @ G.T / dim)
    lp = None
    if r.random() < 0.4:
        ncol = int(r.integers(1, 6))
        nnz = int(r.integers(1, 3 * ncol + 1))
        lp = LPBlockData(
            n_cols=ncol, m=m, obj=np.abs(r.standard_normal(ncol)),
            a_con=r.integers(0, max(m_rand, 1), nnz).astype(np.int32),
            a_col=r.integers(0, ncol, nnz).astype(np.int32),
            a_val=r.standard_normal(nnz))
    rhs = np.zeros(m)
    for b, Xb in zip(blocks, X_point):
        for i, a, bb, v in zip(b.a_con, b.a_row, b.a_col, b.a_val):
            rhs[i] += v * Xb[a, bb] * (1 if a == bb else 2)
    if lp is not None:
        x = np.abs(r.standard_normal(lp.n_cols))
        for c_, col, v in zip(lp.a_con, lp.a_col, lp.a_val):
            rhs[c_] += v * x[col]
    return SDPProblem(m=m, rhs=rhs, blocks=blocks, lp=lp)


@pytest.mark.parametrize("seed", [0, 1, 5, 11])
def test_random_mixed_instances_certify(seed):
    # robustness sweep: random block dims (incl. dim 1), constraints
    # skipping blocks, LP blocks — all must reach full certification
    # (12-seed sweep ran clean; these 4 are the committed sample)
    prob = _random_bounded_problem(seed)
    res = LoradsSolver(prob, LoradsParams(verbose=False,
                                          time_sec_limit=60)).solve()
    assert res.pinf_l1 <= 1e-4
    assert res.status.value == "primal_dual_optimal"


def test_x_blocks_reconstruction():
    # primal extraction: X_i = R_i R_i^T satisfies the constraints and
    # reproduces the reported objective, in original block order
    import numpy as np

    problem = generators.random_multiblock(n_blocks=3, dim=10, m=8,
                                           n_lp=3, seed=5)
    s = LoradsSolver(problem, LoradsParams(verbose=False))
    res = s.solve()
    xs, lp_vals = s.x_blocks(res.R)
    assert len(xs) == 3 and lp_vals.shape == (3,)
    pobj = 0.0
    av = np.zeros(problem.m)
    for blk, X in zip(problem.blocks, xs):
        assert X.shape == (blk.dim, blk.dim)
        # PSD by construction; symmetric
        np.testing.assert_allclose(X, X.T, atol=1e-12)
        pobj += np.sum(blk.dense_obj() * X)
        for i in range(problem.m):
            av[i] += np.sum(blk.dense_constr(i) * X)
    pobj += float(np.dot(problem.lp.obj, lp_vals))
    A = problem.lp.dense_matrix()
    av += A @ lp_vals
    assert np.linalg.norm(av - problem.rhs) / (1 + np.linalg.norm(
        problem.rhs, 1)) <= 1e-4
    assert pobj == pytest.approx(res.pobj, rel=1e-5, abs=1e-6)


def test_high_acc_mode_end_to_end():
    problem = generators.maxcut(n=150, avg_degree=4, seed=8)
    res = LoradsSolver(problem, LoradsParams(
        verbose=False, high_acc_mode=True)).solve()
    assert res.pinf_l1 <= 1e-5
    assert res.status.value == "primal_dual_optimal"


def test_batched_instance_solving():
    # batch solving: merge same-shape independent instances
    # into one block-diagonal problem; per-instance objectives match
    # the individual solves (they share one vectorized bucket)
    from lorads_tpu.core.problem import merge_problems, split_objectives

    # n=120 puts the blocks in SPARSE diag-identity mode: the batch
    # then exercises the Gauss-Seidel per-block bucket slicing in ADMM
    # (regression: build_w/constr_vals zero planes were sized from the
    # static bucket B instead of the runtime slice batch)
    probs = [generators.maxcut(n=120, avg_degree=5, seed=s)
             for s in (1, 2, 3, 4)]
    singles = [LoradsSolver(p, LoradsParams(verbose=False)).solve().pobj
               for p in probs]
    merged = merge_problems(probs)
    s = LoradsSolver(merged, LoradsParams(verbose=False))
    assert len(s.pd.buckets) == 1 and s.pd.buckets[0].B == 4
    res = s.solve()
    assert res.pinf_l1 <= 1e-5
    xs, lp_vals = s.x_blocks(res.R)
    objs = split_objectives(probs, xs, lp_vals)
    for got, ref in zip(objs, singles):
        assert got == pytest.approx(ref, rel=1e-4)


def test_split_objectives_lp_requires_lp_vals():
    # instances with an LP block must get the merged lp_vals — the
    # documented lp_vals=None default only applies to SDP-only batches
    from lorads_tpu.core.problem import (merge_problems, split_objectives,
                                         split_objectives_factors)

    probs = [generators.random_multiblock(n_blocks=1, dim=12, m=6,
                                          n_lp=4, seed=s)
             for s in (1, 2)]
    merged = merge_problems(probs)
    s = LoradsSolver(merged, LoradsParams(verbose=False))
    res = s.solve()
    xs, lp_vals = s.x_blocks(res.R)
    assert lp_vals is not None
    with pytest.raises(ValueError, match="LP block"):
        split_objectives(probs, xs)
    fs, _ = s.factor_blocks()
    with pytest.raises(ValueError, match="LP block"):
        split_objectives_factors(probs, fs)
    # with lp_vals both forms agree
    a = split_objectives(probs, xs, lp_vals)
    b = split_objectives_factors(probs, fs, lp_vals)
    for x, y in zip(a, b):
        assert x == pytest.approx(y, rel=1e-6, abs=1e-8)


def test_phase2_exit_margin():
    """VERDICT r3 #6: the Phase-II exit must not leave the reported
    pinf riding the acceptance band's edge (BENCH_r03 theta families
    finished at 0.99x tol, where a 0.1% perturbation flips
    `converged`).  The ADMM chunk converges to EXIT_MARGIN * tol."""
    from lorads_tpu.alg.admm import EXIT_MARGIN

    assert EXIT_MARGIN <= 0.95
    problem = generators.lovasz_theta(n=60, avg_degree=6, seed=5)
    res = _solve(problem)
    assert res.status in (SolverStatus.PRIMAL_DUAL_OPTIMAL,
                          SolverStatus.PRIMAL_OPTIMAL)
    # theta has b_nrm1 == b_nrm_inf, so the exit band is pinf_l1
    # directly: the margin keeps it strictly inside tol
    assert res.pinf_l1 <= 0.95 * 1e-5


def test_alm_grind_escalates_history():
    """Auto-history solves that pile up ALM inner iterations restart
    the phase with L-BFGS history 4 (round 4; the bench theta n=800
    instance ground 12k inners / 46.5s at history 2 vs 3k / 3.6s at
    4).  Simulated by entering the phase with the cumulative inner
    counter already past the threshold and a 1-iteration dispatch
    budget (so the host loop regains control mid-phase)."""
    import time as _time

    from lorads_tpu.alg.alm import ALMStats, GRIND_INNER_THRESHOLD

    problem = generators.maxcut(n=300, avg_degree=4, seed=3)
    s = LoradsSolver(problem, LoradsParams(verbose=False))
    assert s._lbfgs_auto and s.lbfgs_len == 3
    s.alm_inner_budget = 1
    stats = ALMStats(rho=s.ps.rho0)
    stats.inner_iter = GRIND_INNER_THRESHOLD
    action = s.alm_phase(stats, _time.time())
    assert action == "done"
    assert s.lbfgs_len == 4          # escalated mid-phase
    # explicit history keeps exact reference behavior (no escalation)
    s2 = LoradsSolver(problem, LoradsParams(verbose=False,
                                            lbfgs_list_length=2))
    s2.alm_inner_budget = 1
    st2 = ALMStats(rho=s2.ps.rho0)
    st2.inner_iter = GRIND_INNER_THRESHOLD
    s2.alm_phase(st2, _time.time())
    assert s2.lbfgs_len == 2


def test_lp_gauss_seidel_sweep_order():
    """VERDICT r4 missing #1: the opt-in Gauss-Seidel LP sweep
    (params.lp_gauss_seidel) must reproduce the EXACT reference column
    order — each column's wsum reading the constrValSum already
    updated by previous columns (lorads_admm.c:595-628) — and must
    DIFFER from the default Jacobi sweep on a coupled block (else the
    test proves nothing about ordering)."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from lorads_tpu.alg import admm
    from lorads_tpu.core.problem import LPBlockData
    from lorads_tpu.ops.lp import build_lp_data

    rng = np.random.default_rng(5)
    m, n_cols = 7, 12
    A = rng.standard_normal((m, n_cols))
    A *= rng.random((m, n_cols)) < 0.7          # coupled, sparse-ish
    con, col = np.nonzero(A)
    lp = LPBlockData(n_cols=n_cols, m=m,
                     obj=rng.standard_normal(n_cols),
                     a_con=con.astype(np.int32),
                     a_col=col.astype(np.int32),
                     a_val=A[con, col])
    lpd = build_lp_data(lp, jnp.float64)
    rhs = rng.standard_normal(m)
    pd = SimpleNamespace(lp=lpd, rhs=jnp.asarray(rhs))
    u = rng.random(n_cols) + 0.1
    v = rng.random(n_cols) + 0.1
    dual = rng.standard_normal(m)
    rho = 0.7                                    # low rho: coupling bites
    contrib = A @ (u * v)
    extra = rng.standard_normal(m) * 0.3         # pretend-SDP part
    csum = contrib + extra

    got_u, got_contrib, got_sum = admm._update_lp_var_gs(
        pd, jnp.asarray(u), jnp.asarray(v), jnp.asarray(contrib),
        jnp.asarray(csum), jnp.asarray(dual), jnp.asarray(rho))

    # independent numpy sequential reference (reference column order)
    cs = csum.copy()
    u_ref = u.copy()
    nrm2 = (A ** 2).sum(axis=0)
    for j in range(n_cols):
        a_j = A[:, j]
        base = a_j @ (rho * (cs - rhs) - dual)
        wsum = lp.obj[j] + base - rho * nrm2[j] * u_ref[j] * v[j]
        m2 = wsum * v[j] - rho * v[j]
        new_j = (-m2 / rho) / (1.0 + nrm2[j] * v[j] * v[j])
        cs = cs + a_j * (new_j - u_ref[j]) * v[j]
        u_ref[j] = new_j
    np.testing.assert_allclose(np.asarray(got_u), u_ref, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got_sum), cs, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(got_contrib),
                               A @ (u_ref * v), rtol=1e-10, atol=1e-12)

    # the Jacobi sweep must give a DIFFERENT iterate here
    jac_u, _, _ = admm._update_lp_var(
        pd, jnp.asarray(u), jnp.asarray(v), jnp.asarray(contrib),
        jnp.asarray(csum), jnp.asarray(dual), jnp.asarray(rho))
    assert np.max(np.abs(np.asarray(jac_u) - u_ref)) > 1e-3


def test_lp_gauss_seidel_end_to_end():
    """Both LP sweep orders converge on a coupled LP-heavy instance to
    the same objective (identical fixed points)."""
    problem = generators.random_multiblock(n_blocks=2, dim=8, m=14,
                                           n_lp=10, seed=13)
    res_j = _solve(problem)
    res_g = _solve(problem, lp_gauss_seidel=True)
    for res in (res_j, res_g):
        assert res.pinf_l1 <= 1e-4
        assert res.gap <= 1e-3
    assert res_g.pobj == pytest.approx(res_j.pobj, abs=1e-3)


def test_fix_init_point_trace(capfd):
    """fix_init_point prints the reference's per-iteration nrm2U/tau
    debug trace (lorads_alm.c:1081-1089, 1116-1118)."""
    import importlib

    from lorads_tpu.alg import alm as alm_mod

    problem = generators.maxcut(n=24, avg_degree=4, seed=2)
    try:
        _solve(problem, fix_init_point=True, max_alm_iter=2,
               max_admm_iter=5)
        out, _ = capfd.readouterr()
        assert "nrm2U: " in out
        assert "tau: " in out
    finally:
        alm_mod.TRACE_FIX_INI = False
