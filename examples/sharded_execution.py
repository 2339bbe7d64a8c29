"""Multi-device execution of the solver building blocks.

Demonstrates the three sharding modes on a virtual 8-device CPU mesh:
  * dp — cone blocks spread over devices (multi-block problems)
  * sp — one big cone with its union pattern spread over devices
  * tp — one big dense cone with its O(n^2) intermediates sharded by
         row slab (distributed dsyr2k/dsymm)

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      JAX_PLATFORMS=cpu \
      python examples/sharded_execution.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np

from lorads_tpu import LoradsParams
from lorads_tpu.alg.solver import LoradsSolver
from lorads_tpu.io import generators


def dp_blocks(n_devices):
    """8 same-shape cone blocks, one per device."""
    from lorads_tpu.parallel.sharded import make_mesh, sharded_solver_step

    problem = generators.random_multiblock(n_blocks=n_devices, dim=16,
                                           m=12, seed=0)
    solver = LoradsSolver(problem, LoradsParams(verbose=False))
    mesh = make_mesh(n_devices)
    U1, V1, total, grad = sharded_solver_step(
        mesh, solver.pd, solver.U, solver.V, solver.dual, 1.0)
    print(f"dp: {n_devices} blocks over {n_devices} devices; "
          f"constraint sum |r| = "
          f"{float(jnp.linalg.norm(solver.pd.rhs - total)):.3e}")


def sp_pattern(n_devices):
    """One Max-Cut cone with the union pattern sharded."""
    from lorads_tpu.parallel import pattern_sharded as psh

    problem = generators.maxcut(n=256, avg_degree=6, seed=0)
    solver = LoradsSolver(problem, LoradsParams(verbose=False))
    bk = psh.build_pattern_shards(solver.ps.plans[0], problem.m,
                                  n_devices, solver.dtype)
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:n_devices]), (psh.AXIS,))
    step = psh.make_sharded_gradient(mesh, bk, solver.pd.rhs,
                                     solver.pd.c_nrm_inf)
    total, grad, cert = step(bk, solver.R.cones[0][0], solver.pd.rhs,
                             solver.dual,
                             jnp.asarray(1.0, solver.dtype))
    print(f"sp: pattern of K={solver.ps.plans[0].K} over "
          f"{n_devices} devices; grad cert = {float(cert):.3e}")


def tp_row_slab(n_devices):
    """Row-slab tensor parallelism for a single large dense cone."""
    from lorads_tpu.parallel import row_sharded as rsh

    problem = generators.random_multiblock(n_blocks=1, dim=18, m=14,
                                           density=0.6, seed=11)
    solver = LoradsSolver(problem, LoradsParams(verbose=False))
    plan = solver.ps.plans[0]
    rs = rsh.build_row_shards(plan, problem.m, n_devices, solver.dtype)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n_devices]),
                             (rsh.AXIS,))
    step = rsh.make_row_sharded_gradient(mesh, rs, solver.pd.c_nrm_inf)
    total, grad, cert = step(rs, solver.R.cones[0][0], solver.pd.rhs,
                             solver.dual,
                             jnp.asarray(1.0, solver.dtype))
    print(f"tp: dense cone rows slabbed over {n_devices} devices; "
          f"grad {grad.shape}, cert = {float(cert):.3e}")


def integrated_solves(n_devices):
    """Full two-phase solves with the solver's own sharding modes."""
    # dp: bucket block axis over the mesh
    problem = generators.random_multiblock(n_blocks=n_devices, dim=16,
                                           m=12, seed=0)
    res = LoradsSolver(problem,
                       LoradsParams(verbose=False, shard="dp")).solve()
    print(f"integrated dp solve: {res.status.value}, "
          f"pinf {res.pinf_l1:.2e}, gap {res.gap:.2e}")

    # sp: one large sparse cone, union pattern over the mesh
    problem = generators.maxcut(n=256, avg_degree=4, seed=0)
    res = LoradsSolver(problem,
                       LoradsParams(verbose=False, shard="sp")).solve()
    print(f"integrated sp solve: {res.status.value}, "
          f"pinf {res.pinf_l1:.2e}, gap {res.gap:.2e}")

    # tp: one large dense cone, n x n intermediates as row slabs over
    # the mesh (per-chip memory ceiling n^2/D)
    problem = generators.random_multiblock(n_blocks=1, dim=32, m=24,
                                           density=0.3, seed=7)
    solver = LoradsSolver(problem,
                          LoradsParams(verbose=False, shard="tp"))
    assert solver.pd.buckets[0].rowshard
    res = solver.solve()
    print(f"integrated tp solve: {res.status.value}, "
          f"pinf {res.pinf_l1:.2e}, gap {res.gap:.2e}")


if __name__ == "__main__":
    n = min(8, len(jax.devices()))
    dp_blocks(n)
    sp_pattern(n)
    tp_row_slab(n)
    integrated_solves(n)
