"""Pattern/LP kernels vs dense NumPy oracles (SURVEY.md §4 strategy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lorads_tpu.config import LoradsParams
from lorads_tpu.core.presolve import presolve
from lorads_tpu.io import generators
from lorads_tpu.ops import lp as lp_ops
from lorads_tpu.ops import pattern as pat


def _setup(problem, group=True, **pk):
    # dense_threshold > 1 must force sparse mode: lift the per-matrix
    # rule too (it silently forced dense mode and masked a sparse-mode
    # build_w bug in round 1)
    if pk.get("dense_threshold", 0) > 1:
        pk.setdefault("per_matrix_dense_threshold", 1.1)
    params = LoradsParams(**pk)
    ps = presolve(problem, params, group=group)
    bks = [pat.build_bucket_data(bp, problem.m, jnp.float64)
           for bp in ps.buckets]
    return ps, bks


def _rand_factors(ps, bucket_idx, r, seed=0):
    rng = np.random.default_rng(seed)
    bp = ps.buckets[bucket_idx]
    U = rng.standard_normal((bp.B, bp.n, r))
    V = rng.standard_normal((bp.B, bp.n, r))
    # zero padded rows so oracles line up with real dims
    for b, p in enumerate(bp.plans):
        U[b, p.dim:, :] = 0.0
        V[b, p.dim:, :] = 0.0
    return U, V


def _oracle_sym(U, V):
    return 0.5 * (U @ V.T + V @ U.T)


@pytest.mark.parametrize("dense_thr", [0.0, 1.1])
def test_constr_and_obj_vals(dense_thr):
    # dense_thr 0.0 -> everything dense mode; 1.1 -> sparse mode
    problem = generators.random_multiblock(n_blocks=3, dim=12, m=9, seed=1)
    ps, bks = _setup(problem, dense_threshold=dense_thr,
                     dense_dim_threshold=0)
    assert all(bk.dense == (dense_thr == 0.0) for bk in bks)
    r = 4
    total = np.zeros(problem.m)
    obj_total = 0.0
    for ib, (bp, bk) in enumerate(zip(ps.buckets, bks)):
        U, V = _rand_factors(ps, ib, r, seed=ib)
        uvt_val = pat.uvt(bk, jnp.asarray(U), jnp.asarray(V))
        vals = pat.constr_vals(bk, uvt_val)
        glob = pat.scatter_constr(bk, vals)
        total += np.asarray(glob)
        obj_total += float(jnp.sum(pat.obj_inner(bk, uvt_val)))

    # oracle
    expect = np.zeros(problem.m)
    obj_expect = 0.0
    for ib, bp in enumerate(ps.buckets):
        U, V = _rand_factors(ps, ib, r, seed=ib)
        for b, plan in enumerate(bp.plans):
            blk = problem.blocks[plan.index]
            X = _oracle_sym(U[b][: blk.dim], V[b][: blk.dim])
            for i in range(problem.m):
                expect[i] += np.sum(blk.dense_constr(i) * X)
            obj_expect += np.sum(blk.dense_obj() * X)
    np.testing.assert_allclose(total, expect, rtol=1e-10, atol=1e-12)
    assert obj_total == pytest.approx(obj_expect, rel=1e-10)


@pytest.mark.parametrize("dense_thr", [0.0, 1.1])
def test_build_w_and_mul(dense_thr):
    problem = generators.random_multiblock(n_blocks=2, dim=10, m=7, seed=2)
    ps, bks = _setup(problem, dense_threshold=dense_thr,
                     dense_dim_threshold=0)
    rng = np.random.default_rng(0)
    w = rng.standard_normal(problem.m)
    r = 3
    for ib, (bp, bk) in enumerate(zip(ps.buckets, bks)):
        U, _ = _rand_factors(ps, ib, r, seed=10 + ib)
        w_loc = pat.gather_w(bk, jnp.asarray(w))
        W = pat.build_w(bk, w_loc)
        WX = np.asarray(pat.w_mul(bk, W, jnp.asarray(U)))
        for b, plan in enumerate(bp.plans):
            blk = problem.blocks[plan.index]
            Wd = blk.dense_obj().copy()
            for i in range(problem.m):
                Wd += w[i] * blk.dense_constr(i)
            expect = Wd @ U[b][: blk.dim]
            np.testing.assert_allclose(WX[b][: blk.dim], expect,
                                       rtol=1e-10, atol=1e-10)


def test_sparse_cone_compaction():
    # constraints that never touch a block must not appear in its slots
    problem = generators.random_multiblock(n_blocks=1, dim=8, m=6, seed=4)
    blk = problem.blocks[0]
    keep = blk.a_con != 2  # remove constraint 2 from the block
    blk.a_con, blk.a_row, blk.a_col, blk.a_val = (
        blk.a_con[keep], blk.a_row[keep], blk.a_col[keep], blk.a_val[keep])
    ps, bks = _setup(problem, dense_threshold=1.1, dense_dim_threshold=0)
    assert ps.plans[0].m_loc == 5
    U, V = _rand_factors(ps, 0, 3)
    _, glob = pat.auv_into_global(bks[0], jnp.asarray(U), jnp.asarray(V))
    assert np.asarray(glob)[2] == 0.0


def test_lp_kernels():
    problem = generators.random_multiblock(n_blocks=1, dim=6, m=8, n_lp=5,
                                           seed=5)
    lpd = lp_ops.build_lp_data(problem.lp, jnp.float64)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(5)
    v = rng.standard_normal(5)
    w = rng.standard_normal(8)
    A = problem.lp.dense_matrix()
    # f64 sums now route through the compensated pair scan whose error
    # contract is ~2^-47 |prefix| (pattern.comp_segment_sum) — a hair
    # above f64 ulp on small outputs, hence rtol 1e-11 + tiny atol
    np.testing.assert_allclose(
        np.asarray(lp_ops.constr_vals(lpd, jnp.asarray(u * v))),
        A @ (u * v), rtol=1e-11, atol=1e-13)
    assert float(lp_ops.obj_inner(lpd, jnp.asarray(u * v))) == pytest.approx(
        problem.lp.obj @ (u * v), rel=1e-12)
    np.testing.assert_allclose(np.asarray(lp_ops.adjoint_cols(
        lpd, jnp.asarray(w))), A.T @ w, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(np.asarray(lpd.col_nrm2sq),
                               np.sum(A**2, axis=0), rtol=1e-12)


def test_rank_rule():
    # r = min(ceil(t*ln n), floor(sqrt(2*m_loc))+1, n), >= 1
    # (lorads_solver.c:290-319)
    problem = generators.maxcut(n=100, avg_degree=4, seed=0)
    ps, _ = _setup(problem)
    plan = ps.plans[0]
    assert plan.rank == min(int(np.ceil(2.0 * np.log(100))),
                            int(np.sqrt(2 * 100)) + 1, 100)
    assert plan.rank_max == min(int(np.sqrt(2 * 100)) + 1, 100)


def test_dense_mode_thresholds():
    # dim < 20 forces dense union buffers (lorads_sdp_conic.c:884)
    problem = generators.random_multiblock(n_blocks=1, dim=10, m=5,
                                           density=0.05, seed=6)
    ps, _ = _setup(problem)
    assert ps.plans[0].dense
    # large sparse maxcut block stays sparse
    problem = generators.maxcut(n=300, avg_degree=4, seed=0)
    ps, _ = _setup(problem)
    assert not ps.plans[0].dense


def test_split_vs_union_parity():
    """Diag/offdiag split kernels match the union-pattern kernels on a
    sparse-mode problem with mixed diag and offdiag constraint entries."""
    problem = generators.lovasz_theta(n=140, avg_degree=6, seed=3)
    params = LoradsParams(dense_threshold=1.01,
                          per_matrix_dense_threshold=1.1,
                          dense_dim_threshold=0)
    ps = presolve(problem, params)
    for bp in ps.buckets:
        bku = pat.build_bucket_data(bp, problem.m, jnp.float64, split=False)
        bks = pat.build_bucket_data(bp, problem.m, jnp.float64, split=True)
        assert not bku.split and bks.split
        rng = np.random.default_rng(0)
        r = 7
        U = jnp.asarray(rng.standard_normal((bp.B, bp.n, r)))
        V = jnp.asarray(rng.standard_normal((bp.B, bp.n, r)))
        w = jnp.asarray(rng.standard_normal((bp.B, bp.m_loc)))

        uv_u = pat.uvt(bku, U, V)
        uv_s = pat.uvt(bks, U, V)
        np.testing.assert_allclose(
            np.asarray(pat.constr_vals(bks, uv_s)),
            np.asarray(pat.constr_vals(bku, uv_u)), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(pat.obj_inner(bks, uv_s)),
            np.asarray(pat.obj_inner(bku, uv_u)), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(pat.w_mul(bks, pat.build_w(bks, w), U)),
            np.asarray(pat.w_mul(bku, pat.build_w(bku, w), U)),
            rtol=1e-9, atol=1e-11)
        # pair evaluation
        (rd_s, dd_s) = pat.uvt_pair(bks, U, V)
        np.testing.assert_allclose(
            np.asarray(pat.obj_inner(bks, rd_s)),
            np.asarray(pat.obj_inner(bku, pat.uvt(bku, U, V))),
            rtol=1e-10)
        np.testing.assert_allclose(
            np.asarray(pat.constr_vals(bks, dd_s)),
            np.asarray(pat.constr_vals(bku, pat.uvt(bku, V, V))),
            rtol=1e-10, atol=1e-12)


def test_split_diag_ident_maxcut():
    """Max-Cut's A_i = e_i e_i^T is detected as the diag-identity
    structure and the dense constraint path matches the oracle."""
    problem = generators.maxcut(n=120, avg_degree=5, seed=7)
    params = LoradsParams(dense_threshold=1.01,
                          per_matrix_dense_threshold=1.1,
                          dense_dim_threshold=0)
    ps = presolve(problem, params)
    bp = ps.buckets[0]
    bk = pat.build_bucket_data(bp, problem.m, jnp.float64)
    assert bk.split and bk.diag_ident and not bk.has_off_a
    rng = np.random.default_rng(1)
    U = rng.standard_normal((1, bp.n, 5))
    V = rng.standard_normal((1, bp.n, 5))
    X = _oracle_sym(U[0], V[0])
    vals = pat.constr_vals(bk, pat.uvt(bk, jnp.asarray(U), jnp.asarray(V)))
    np.testing.assert_allclose(np.asarray(vals)[0], np.diag(X), rtol=1e-10)


def test_bounded_segment_sum_matches_scatter():
    # the f64 scatter-free path (cumsum + static boundary gathers) must
    # agree with the scatter segment sum on sorted ids, for 2D and 3D
    # data and B>1
    rng = np.random.default_rng(4)
    B, K, S, r = 3, 50, 17, 5
    ids = np.sort(rng.integers(0, S, (B, K)).astype(np.int32), axis=1)
    bounds = pat._bounds_np(ids, S)
    for shape in [(B, K), (B, K, r)]:
        data = jnp.asarray(rng.standard_normal(shape))
        ref = pat.batched_segment_sum(
            data.astype(jnp.float32), jnp.asarray(ids), S,
            sorted_ids=True)
        got = pat.bounded_segment_sum(data.astype(jnp.float64), bounds)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
        # f64 data routed through batched_segment_sum takes the bounded
        # path (CUMSUM_F64 default on) and must match the f64 scatter
        got2 = pat.batched_segment_sum(
            data.astype(jnp.float64), jnp.asarray(ids), S,
            sorted_ids=True, bounds=bounds)
        prev = pat.CUMSUM_F64
        try:
            pat.CUMSUM_F64 = False
            ref64 = pat.batched_segment_sum(
                data.astype(jnp.float64), jnp.asarray(ids), S,
                sorted_ids=True, bounds=bounds)
        finally:
            pat.CUMSUM_F64 = prev
        np.testing.assert_allclose(np.asarray(got2), np.asarray(ref64),
                                   rtol=1e-12, atol=1e-12)


def test_f64_bounded_path_full_kernels_parity():
    # whole-kernel parity: constr_vals / build_w / w_mul at f64 with the
    # bounded path on vs off (scatter) on a sparse-mode instance
    problem = generators.random_multiblock(n_blocks=2, dim=14, m=10,
                                           seed=8)
    ps, bks = _setup(problem, dense_threshold=1.1,
                     dense_dim_threshold=0)
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal(problem.m))
    r = 3
    for ib, (bp, bk) in enumerate(zip(ps.buckets, bks)):
        U, V = _rand_factors(ps, ib, r, seed=20 + ib)
        U, V = jnp.asarray(U), jnp.asarray(V)

        def run():
            uvt_val = pat.uvt(bk, U, V)
            vals = pat.constr_vals(bk, uvt_val)
            glob = pat.scatter_constr(bk, vals)
            W = pat.build_w(bk, pat.gather_w(bk, w))
            WX = pat.w_mul(bk, W, U)
            cache = pat.gather_cache(bk, U)
            WXc = pat.w_mul_cached(bk, W, U, cache)
            return glob, WX, WXc

        prev = pat.CUMSUM_F64
        try:
            pat.CUMSUM_F64 = True
            on = run()
            pat.CUMSUM_F64 = False
            off = run()
        finally:
            pat.CUMSUM_F64 = prev
        for a, b in zip(on, off):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12, atol=1e-12)


def test_dense_f64_two_plane_build_w_theta():
    # lovasz_theta is dense-mode with unique W slots (a_lin2_exact):
    # the f64 build_w two-plane f32 scatter must match the dense oracle
    problem = generators.lovasz_theta(n=24, avg_degree=5, seed=2)
    ps, bks = _setup(problem, dense_threshold=0.0, dense_dim_threshold=0)
    bk = bks[0]
    assert bk.dense and bk.a_lin2_exact
    rng = np.random.default_rng(1)
    w = rng.standard_normal(problem.m)
    W = np.asarray(pat.build_w(bk, pat.gather_w(bk, jnp.asarray(w))))
    blk = problem.blocks[0]
    Wd = blk.dense_obj().copy()
    for i in range(problem.m):
        Wd += w[i] * blk.dense_constr(i)
    np.testing.assert_allclose(W[0], Wd, rtol=1e-13, atol=1e-13)


def test_scale_objective_keeps_col_mirror_consistent():
    # regression: scale_objective missed c_off_cp (the col-order mirror
    # of C), so after a reopt rescale build_w's upper-half pass carried
    # the UNSCALED objective.  Invariant: the col-order W plane is a
    # static permutation of the row-order plane, scaled or not.
    from lorads_tpu.alg import aop

    problem = generators.maxcut(n=200, avg_degree=4, seed=5)
    params = LoradsParams()
    ps = presolve(problem, params, group=True)
    pd = aop.build_problem_data(ps, jnp.float64)
    pd5 = aop.scale_objective(pd, 5.0)
    bk = pd5.buckets[0]
    assert bk.split and bk.has_off
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal(problem.m))
    _, W_o, W_oc = pat.build_w(bk, pat.gather_w(bk, w))
    mirror = jnp.take_along_axis(W_o, bk.off_col_perm, axis=1)
    np.testing.assert_allclose(np.asarray(W_oc), np.asarray(mirror),
                               rtol=1e-12, atol=1e-12)


def test_diag_fast_path_matches_generic():
    # diag-identity ALM fast path: the CRCache operators (cmul-based
    # gradient, pair eval, obj/auv refresh, cache axpy) match the
    # generic pattern path exactly on a Max-Cut block
    from lorads_tpu.alg import aop
    from lorads_tpu.alg.solver import LoradsSolver

    problem = generators.maxcut(n=300, avg_degree=4, seed=3)
    s = LoradsSolver(problem, LoradsParams(verbose=False))
    pd, R = s.pd, s.R
    bk = pd.buckets[0]
    assert aop._diag_fast(bk) and bk.glob_ident
    rng = np.random.default_rng(0)
    D = type(R)(tuple(jnp.asarray(rng.standard_normal(x.shape))
                      for x in R.cones), R.lp)
    w = jnp.asarray(rng.standard_normal(problem.m))

    ca = aop.gather_caches(pd, R)
    assert isinstance(ca[0], aop.CRCache)
    p1, t1, p2, t2, dca = aop.obj_and_auv_pair_cached(pd, R, D, ca)
    p1o, t1o, p2o, t2o = aop.obj_and_auv_pair(pd, R, D)
    assert float(p1) == pytest.approx(float(p1o), rel=1e-11)
    assert float(p2) == pytest.approx(float(p2o), rel=1e-11)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t1o),
                               rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(np.asarray(t2), np.asarray(t2o),
                               rtol=1e-11, atol=1e-12)

    W = pat.build_w(bk, pat.gather_w(bk, w))
    go = 2.0 * pat.w_mul(bk, W, R.cones[0])
    g = aop.grad_cached(pd, R, w, ca)
    np.testing.assert_allclose(np.asarray(g.cones[0]), np.asarray(go),
                               rtol=1e-12, atol=1e-12)
    g2 = aop.grad(pd, R, w)
    np.testing.assert_allclose(np.asarray(g2.cones[0]), np.asarray(go),
                               rtol=1e-12, atol=1e-12)

    _, toto = aop.auv(pd, R, R)
    np.testing.assert_allclose(np.asarray(aop.auv_cached(pd, R, ca)),
                               np.asarray(toto), rtol=1e-12, atol=1e-12)
    assert float(aop.obj_cached(pd, R, ca)) == pytest.approx(
        float(aop.obj_only(pd, R, R)), rel=1e-12)

    # cache advances exactly like the factor: C(R + t D) = CR + t CD
    ca2 = aop.axpy_caches(ca, 0.37, dca)
    ca2f = aop.gather_caches(pd, R.axpy(0.37, D))
    np.testing.assert_allclose(np.asarray(ca2[0].cr),
                               np.asarray(ca2f[0].cr),
                               rtol=1e-11, atol=1e-12)


def test_cmul_f32_cumsum_accuracy():
    # the f32 scatter-free cumsum route in cmul stays within the
    # gradient-path error budget (~1e-5 relative) vs the f64 oracle
    from lorads_tpu.alg import aop

    problem = generators.maxcut(n=500, avg_degree=8, seed=9)
    ps = presolve(problem, LoradsParams(), group=True)
    pd32 = aop.build_problem_data(ps, jnp.float32)
    pd64 = aop.build_problem_data(ps, jnp.float64)
    bk32, bk64 = pd32.buckets[0], pd64.buckets[0]
    assert bk32.split and bk32.has_off
    rng = np.random.default_rng(4)
    X = rng.standard_normal((1, bk64.n, 8))
    got = np.asarray(pat.cmul(bk32, jnp.asarray(X, jnp.float32)))
    ref = np.asarray(pat.cmul(bk64, jnp.asarray(X)))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 5e-5 * scale


def test_scale_objective_scales_cmul_plane():
    # regression: scale_objective missed c_sym_rs (the full-symmetric
    # C plane consumed by the diag-fast cmul), so reopt's objective
    # rescale left the CR cache computing with unscaled off-diagonals
    from lorads_tpu.alg import aop

    problem = generators.maxcut(n=200, avg_degree=4, seed=5)
    ps = presolve(problem, LoradsParams(), group=True)
    pd = aop.scale_objective(aop.build_problem_data(ps, jnp.float64), 5.0)
    rng = np.random.default_rng(1)
    from lorads_tpu.alg.state import FactorVec
    R = FactorVec((jnp.asarray(rng.standard_normal((1, 200, 6))),),
                  jnp.zeros((0,)))
    ca = aop.gather_caches(pd, R)
    assert isinstance(ca[0], aop.CRCache)
    obj_fast = float(aop.obj_cached(pd, R, ca))
    obj_ref = float(aop.obj_only(pd, R, R))
    assert obj_fast == pytest.approx(obj_ref, rel=1e-11)
    w = jnp.asarray(rng.standard_normal(problem.m))
    g_fast = aop.grad_cached(pd, R, w, ca)
    g_ref = aop.grad(pd, R, w)   # grad also uses cmul; compare to w_mul
    from lorads_tpu.ops import pattern as pat
    bk = pd.buckets[0]
    W = pat.build_w(bk, pat.gather_w(bk, w))
    g_oracle = 2.0 * pat.w_mul(bk, W, R.cones[0])
    np.testing.assert_allclose(np.asarray(g_fast.cones[0]),
                               np.asarray(g_oracle), rtol=1e-11,
                               atol=1e-11)


def test_a_adj_a_matches_generic_composition():
    # fused A*(A(.)) (slot-diagonal off part + generic diag part)
    # equals build_w(constr_vals(.), include_obj=False) exactly on
    # matcomp (pure single-entry constraints) and theta (edges + trace)
    from lorads_tpu.alg import aop
    from lorads_tpu.core.problem import SDPBlockData, SDPProblem

    mc = generators.matrix_completion(n1=80, n2=80, true_rank=2,
                                      frac_obs=0.06, seed=3)
    # matcomp + a trace constraint: exercises the generic diag branch
    # alongside the slot-diagonal off part
    b = mc.blocks[0]
    n = b.dim
    mc_tr = SDPProblem(
        m=mc.m + 1, rhs=np.concatenate([mc.rhs, [1.0]]),
        blocks=[SDPBlockData(
            dim=n, m=mc.m + 1,
            obj_row=b.obj_row, obj_col=b.obj_col, obj_val=b.obj_val,
            a_con=np.concatenate([b.a_con,
                                  np.full(n, mc.m)]).astype(np.int32),
            a_row=np.concatenate([b.a_row,
                                  np.arange(n)]).astype(np.int32),
            a_col=np.concatenate([b.a_col,
                                  np.arange(n)]).astype(np.int32),
            a_val=np.concatenate([b.a_val, np.ones(n)]))])

    for problem in (mc, mc_tr):
        ps = presolve(problem, LoradsParams(), group=True)
        pd = aop.build_problem_data(ps, jnp.float64)
        bk = pd.buckets[0]
        assert bk.split and bk.a_off_unique
        rng = np.random.default_rng(0)
        n = bk.n
        d = jnp.asarray(rng.standard_normal((bk.B, n)))
        o = jnp.asarray(rng.standard_normal((bk.B, bk.Ko)))
        W_ref = pat.build_w(bk, pat.constr_vals(bk, (d, o)),
                            include_obj=False)
        W_fused = pat.a_adj_a(bk, (d, o))
        for a, b in zip(W_fused, W_ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12, atol=1e-12)


def test_a_adj_a_dense_matches_generic_composition():
    # dense-mode fusion: theta (single edges + trace) and a small
    # dense maxcut (diag identities only -> pure diag composition)
    from lorads_tpu.alg import aop

    for problem in (
            generators.lovasz_theta(n=60, avg_degree=6, seed=5),
            generators.maxcut(n=16, avg_degree=5, seed=1)):
        ps = presolve(problem, LoradsParams(), group=True)
        pd = aop.build_problem_data(ps, jnp.float64)
        bk = pd.buckets[0]
        assert bk.dense and bk.a_single_dense
        rng = np.random.default_rng(0)
        X = rng.standard_normal((bk.B, bk.n, bk.n))
        X = 0.5 * (X + np.swapaxes(X, 1, 2))
        Xj = jnp.asarray(X)
        W_ref = pat.build_w(bk, pat.constr_vals(bk, Xj),
                            include_obj=False)
        W_fused = pat.a_adj_a_dense(bk, Xj)
        np.testing.assert_allclose(np.asarray(W_fused),
                                   np.asarray(W_ref),
                                   rtol=1e-12, atol=1e-12)


def test_single_segment_sum_matches_scatter():
    """Single-entry-segment fast path (round 4): when every segment
    statically holds <= 1 entry, batched_segment_sum(single=True) is
    an exact masked boundary-gather — bit-identical to the scatter at
    any dtype (no summation occurs)."""
    import numpy as np

    from lorads_tpu.ops.pattern import (batched_segment_sum,
                                        single_segment_sum)

    rng = np.random.default_rng(0)
    B, S = 3, 40
    # strictly increasing ids with gaps: segments of size <= 1
    ids = np.stack([np.sort(rng.choice(S, size=17, replace=False))
                    for _ in range(B)])
    data = rng.standard_normal((B, 17))
    bounds = np.stack([np.searchsorted(ids[b], np.arange(S + 1))
                       for b in range(B)]).astype(np.int32)
    for dt in (jnp.float32, jnp.float64):
        d = jnp.asarray(data, dt)
        ref = batched_segment_sum(d, jnp.asarray(ids), S,
                                  sorted_ids=True)
        fast = batched_segment_sum(d, jnp.asarray(ids), S,
                                   sorted_ids=True,
                                   bounds=jnp.asarray(bounds),
                                   single=True)
        np.testing.assert_array_equal(np.asarray(fast), np.asarray(ref))
        # 3d data path
        d3 = jnp.asarray(np.repeat(data[:, :, None], 4, axis=2), dt)
        ref3 = batched_segment_sum(d3, jnp.asarray(ids), S,
                                   sorted_ids=True)
        fast3 = single_segment_sum(d3, jnp.asarray(bounds))
        np.testing.assert_array_equal(np.asarray(fast3),
                                      np.asarray(ref3))


def test_comp_segment_sum_accuracy():
    """Round-5 compensated pair-scan path: error ~eps32 |segment| at
    f32 (the raw f32 cumsum difference is eps32 |prefix| — orders
    worse), ~2^-47 |prefix| at f64.  Also guards against an XLA
    simplifier ever folding the TwoSum error term to zero (the f32
    branch would then degrade to the raw-cumsum error and fail)."""
    rng = np.random.default_rng(7)
    B, N, S = 2, 200_000, 1000
    ids = np.sort(rng.integers(0, S, (B, N)).astype(np.int32), axis=1)
    bounds = pat._bounds_np(ids, S)
    # adversarial scale: large-magnitude data so prefixes are ~1e5
    # while most segments are ~sqrt(N/S)*scale
    data64 = rng.standard_normal((B, N))
    exact = np.zeros((B, S))
    for b in range(B):
        np.add.at(exact[b], ids[b], data64[b])

    # f32 path
    got32 = np.asarray(pat.comp_segment_sum(
        jnp.asarray(data64, jnp.float32), bounds))
    seg_l1 = np.zeros((B, S))
    for b in range(B):
        np.add.at(seg_l1[b], ids[b], np.abs(data64[b]))
    err32 = np.abs(got32 - exact)
    # per-segment error bounded by ~8 eps32 * (|segment L1| + |sum|)
    bound = 8 * np.finfo(np.float32).eps * (seg_l1 + np.abs(exact) + 1)
    assert np.all(err32 <= bound), float((err32 / bound).max())
    # raw f32 cumsum diff must be strictly worse on this shape —
    # otherwise the compensation was optimized away silently
    raw32 = np.asarray(pat.bounded_segment_sum(
        jnp.asarray(data64, jnp.float32), bounds))
    assert np.abs(raw32 - exact).max() > 4 * err32.max()

    # f64 (split_f64) path
    got64 = np.asarray(pat.comp_segment_sum(jnp.asarray(data64), bounds))
    pref_l1 = np.abs(data64).sum(axis=1, keepdims=True)
    assert np.abs(got64 - exact).max() <= 1e-13 * pref_l1.max()

    # 3D data
    r = 3
    d3 = rng.standard_normal((B, 4000, r))
    ids3 = np.sort(rng.integers(0, 50, (B, 4000)).astype(np.int32), 1)
    b3 = pat._bounds_np(ids3, 50)
    ex3 = np.zeros((B, 50, r))
    for b in range(B):
        np.add.at(ex3[b], ids3[b], d3[b])
    g3 = np.asarray(pat.comp_segment_sum(
        jnp.asarray(d3, jnp.float32), b3))
    np.testing.assert_allclose(g3, ex3, atol=1e-4, rtol=1e-5)
    g3d = np.asarray(pat.comp_segment_sum(jnp.asarray(d3), b3))
    np.testing.assert_allclose(g3d, ex3, atol=1e-11, rtol=1e-12)


def test_batched_segment_sum_routes_comp():
    """bounds-eligible f32 sums take the compensated path and agree
    with the scatter reference."""
    rng = np.random.default_rng(11)
    B, N, S = 3, 5000, 800
    ids = np.sort(rng.integers(0, S, (B, N)).astype(np.int32), axis=1)
    bounds = pat._bounds_np(ids, S)
    data = jnp.asarray(rng.standard_normal((B, N)), jnp.float32)
    ref = pat.batched_segment_sum(data, jnp.asarray(ids), S,
                                  sorted_ids=True)
    got = pat.batched_segment_sum(data, jnp.asarray(ids), S,
                                  sorted_ids=True, bounds=bounds)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=2e-4, rtol=1e-5)


def test_pair_scan_chunk_edges():
    """The two-level Hillis-Steele pair scan must be exact-grade at
    awkward lengths: below/at/above the chunk width, non-multiples,
    and 3D trailing dims."""
    rng = np.random.default_rng(3)
    from lorads_tpu.ops.pattern import _PAIR_CHUNK, _pair_scan
    for N in (1, 2, _PAIR_CHUNK - 1, _PAIR_CHUNK, 2 * _PAIR_CHUNK,
              2 * _PAIR_CHUNK + 1, 3 * _PAIR_CHUNK + 7):
        for shape in ((2, N), (2, N, 3)):
            d = rng.standard_normal(shape)
            hi = jnp.asarray(d, jnp.float32)
            lo = jnp.zeros_like(hi)
            ph, pl = _pair_scan(hi, lo)
            got = np.asarray(ph, np.float64) + np.asarray(pl, np.float64)
            exact = np.cumsum(d.astype(np.float64), axis=1)
            l1 = np.abs(d).sum(axis=1).max()
            # f32 pair carries the f32-rounded inputs exactly; error
            # vs the f64 cumsum is dominated by the input rounding
            err = np.abs(got - np.cumsum(
                d.astype(np.float32).astype(np.float64), axis=1)).max()
            assert err <= 1e-5 * max(l1, 1.0) * 2 ** -23 * N + 1e-6, \
                (N, shape, err)
            np.testing.assert_allclose(got, exact, atol=1e-3, rtol=1e-5)


def test_cmul_chunked_matches(monkeypatch):
    """cmul's large-pattern chunked path (peak-HBM bound for
    maxcut n>=500000) must equal the single-pass result."""
    problem = generators.maxcut(n=400, avg_degree=6, seed=9)
    ps = presolve(problem, LoradsParams())
    bp = ps.buckets[0]
    bk = pat.build_bucket_data(bp, problem.m, jnp.float64)
    assert bk.split and bk.diag_ident and bk.Ks > 100
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((bk.B, bk.n, 5)))
    ref = np.asarray(pat.cmul(bk, X))
    monkeypatch.setattr(pat, "_CMUL_CHUNK", 137)
    got = np.asarray(pat.cmul(bk, X))
    # 2^-47-class compensated-scan rounding differs per chunking
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    # f32 too (the dtype="auto" start on accelerators)
    bk32 = pat.build_bucket_data(bp, problem.m, jnp.float32)
    X32 = X.astype(jnp.float32)
    monkeypatch.setattr(pat, "_CMUL_CHUNK", 10 ** 9)
    ref32 = np.asarray(pat.cmul(bk32, X32))
    monkeypatch.setattr(pat, "_CMUL_CHUNK", 137)
    got32 = np.asarray(pat.cmul(bk32, X32))
    np.testing.assert_allclose(got32, ref32, rtol=1e-5, atol=1e-5)


def test_split_f64_planes():
    """split_f64: hi is exact in f32, hi + lo recovers x to 2^-47 |x|,
    and the split never rounds through f32 and back (XLA:GPU folds
    such a convert pair to the identity, which zeroed lo)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
    hi, lo = jax.jit(pat.split_f64)(jnp.asarray(x))
    assert hi.dtype == jnp.float32 and lo.dtype == jnp.float32
    h, l_ = np.asarray(hi, np.float64), np.asarray(lo, np.float64)
    assert np.all(np.abs(l_) > 0)
    assert np.all(np.abs(h + l_ - x) <= 2.0 ** -47 * np.abs(x))
    hlo = jax.jit(pat.split_f64).lower(jnp.asarray(x)).as_text()
    assert "tensor<4096xf32>) -> tensor<4096xf64>" not in hlo
