"""Multi-chip execution: cone-block data parallelism over a device mesh.

The reference is single-threaded (SURVEY.md §2: no MPI/NCCL/threads);
the latent concurrency is the block decomposition — cones couple only
through the m-vector constrValSum, a sum over cones.  Device mapping:

* bucket block axis B sharded over mesh axis "blk" (shard_map);
* per-device partial constraint scatters reduced with jax.lax.psum
  (an all-reduce across the devices);
* U/V/dual replicated (factors are n x r, small), CG runs per block
  with no cross-device traffic.

This module provides the building blocks plus a full sharded solver
step used by the driver's multi-chip dryrun.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from lorads_tpu.alg import aop
from lorads_tpu.alg.cg import cg_solve
from lorads_tpu.alg.state import FactorVec
from lorads_tpu.ops import pattern as pat

AXIS = "blk"


def make_mesh(n_devices: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n_devices]), (AXIS,))


def _bucket_spec(bk: pat.BucketData):
    """PartitionSpec pytree: every array leaf sharded on its B axis."""
    return jax.tree.map(lambda _: P(AXIS), bk)


def sharded_solver_step(mesh: Mesh, pd: aop.ProblemData, U: FactorVec,
                        V: FactorVec, dual, rho: float):
    """One combined solver step (ALM gradient + ADMM U/V sweep) with the
    bucket's blocks sharded over the mesh.

    Single-bucket problems only (the dryrun shape); the production
    multi-bucket path loops this per bucket.  Returns
    (U_new, V_new, constr_sum, grad) with factors sharded on B.
    """
    bk = pd.buckets[0]
    rhs = pd.rhs
    bspec = _bucket_spec(bk)
    dt = rhs.dtype
    rho = jnp.asarray(rho, dt)

    @partial(shard_map, mesh=mesh,
             in_specs=(bspec, P(AXIS), P(AXIS), P(), P(), P()),
             out_specs=(P(AXIS), P(AXIS), P(), P(AXIS)))
    def step(bk_loc, U0, V0, rhs_, dual_, rho_):
        # A(sym(U V^T)): local scatter + psum over the mesh
        vals = pat.constr_vals(bk_loc, pat.uvt(bk_loc, U0, V0))
        total = jax.lax.psum(pat.scatter_constr(bk_loc, vals), AXIS)

        # ALM-style gradient at (U0, total)
        w = rho_ * (total - rhs_) - dual_
        Wg = pat.build_w(bk_loc, pat.gather_w(bk_loc, w))
        grad = 2.0 * pat.w_mul(bk_loc, Wg, U0)

        # ADMM U update (Jacobi across blocks; no cross-device CG traffic)
        def update(upd, fixed, vals_cur, total_cur):
            base = rho_ * (total_cur - rhs_) - dual_
            w_loc = pat.gather_w(bk_loc, base) - rho_ * vals_cur
            W = pat.build_w(bk_loc, w_loc)
            M2 = pat.w_mul(bk_loc, W, fixed) - rho_ * fixed

            def op(x):
                v = pat.constr_vals(bk_loc, pat.uvt(bk_loc, x, fixed))
                Wop = pat.build_w(bk_loc, v, include_obj=False)
                return x + pat.w_mul(bk_loc, Wop, fixed)

            new, _ = cg_solve(op, upd, -M2 / rho_, 1e-10, 50)
            new_vals = pat.constr_vals(bk_loc, pat.uvt(bk_loc, new, fixed))
            new_total = total_cur + jax.lax.psum(
                pat.scatter_constr(bk_loc, new_vals - vals_cur), AXIS)
            return new, new_vals, new_total

        U1, vals, total = update(U0, V0, vals, total)
        V1, vals, total = update(V0, U1, vals, total)
        return U1, V1, total, grad

    return step(bk, U.cones[0], V.cones[0], rhs, dual, rho)


def shard_bucket_axis(mesh: Mesh, pd: aop.ProblemData, *fvs: FactorVec):
    """Place bucket arrays + factors with the B axis sharded over the
    mesh (device_put with NamedSharding); returns (pd, *fvs)."""
    from jax.sharding import NamedSharding

    def put(tree, spec_fn):
        return jax.tree.map(
            lambda x: jax.device_put(
                x, NamedSharding(mesh, spec_fn(x))), tree)

    shard_lead = lambda x: P(AXIS) if x.ndim >= 1 else P()
    pd = aop.ProblemData(
        m=pd.m,
        buckets=tuple(put(bk, shard_lead) for bk in pd.buckets),
        lp=pd.lp, rhs=jax.device_put(
            pd.rhs, NamedSharding(mesh, P())),
        c_nrm1=pd.c_nrm1, c_nrm2=pd.c_nrm2, c_nrm_inf=pd.c_nrm_inf,
        b_nrm1=pd.b_nrm1, b_nrm2=pd.b_nrm2, b_nrm_inf=pd.b_nrm_inf)
    out = [pd]
    for fv in fvs:
        out.append(FactorVec(
            tuple(jax.device_put(x, NamedSharding(mesh, P(AXIS)))
                  for x in fv.cones),
            jax.device_put(fv.lp, NamedSharding(mesh, P()))))
    return tuple(out)
