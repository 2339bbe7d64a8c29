"""Time each ALM inner-iteration piece as a standalone jitted call on
the real bench problem data (complements tools/profile_alm.py's
in-loop differencing: if pieces are fast but the loop is slow, the
problem is loop context, not the ops).

Run: PYTHONPATH=. python -u tools/profile_alm_pieces.py
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from lorads_tpu import LoradsParams
from lorads_tpu.alg import aop
from lorads_tpu.alg.linesearch import alm_line_search
from lorads_tpu.alg.solver import LoradsSolver
from lorads_tpu.alg.state import fv_norm2sq, history_push, lbfgs_direction
from lorads_tpu.io import generators


def _drain(out):
    """Wait for the device to finish ``out``."""
    jax.block_until_ready(out)


def trial(name, fn, *args, reps=30):
    out = fn(*args)
    _drain(out)
    t0 = time.time()
    for i in range(reps):
        out = fn(*args)
    _drain(out)
    dt = (time.time() - t0) / reps
    print(f"{name:>40}: {dt * 1e6:9.1f} us", flush=True)
    return dt


def main():
    n = int(os.environ.get("PROF_N", "20000"))
    problem = generators.maxcut(n=n, avg_degree=8, seed=7)
    params = LoradsParams(verbose=False, dtype="f32")
    solver = LoradsSolver(problem, params)
    pd, R, dual, hist = solver.pd, solver.R, solver.dual, solver.hist
    dt = pd.rhs.dtype
    rho = jnp.asarray(solver.ps.rho0, dt)
    print(f"n={n} Ko={pd.buckets[0].Ko} r={R.cones[0].shape[-1]}",
          flush=True)

    caches = jax.jit(aop.gather_caches)(pd, R)
    _, constr_sum = jax.jit(aop.auv)(pd, R, R)
    w = rho * (constr_sum - pd.rhs) - dual
    grad = jax.jit(aop.grad_cached)(pd, R, w, caches)
    D = grad.scale(-1.0)

    trial("gather_caches", jax.jit(aop.gather_caches), pd, R)
    trial("obj_and_auv_pair_cached",
          jax.jit(aop.obj_and_auv_pair_cached), pd, R, D, caches)
    trial("grad_cached", jax.jit(aop.grad_cached), pd, R, w, caches)
    trial("auv_cached", jax.jit(aop.auv_cached), pd, R, caches)
    trial("lbfgs_direction", jax.jit(lbfgs_direction), hist, grad)
    trial("history_push", jax.jit(history_push), hist, D, grad)
    trial("fv_norm2sq", jax.jit(fv_norm2sq), grad)

    p1, t1, p2, t2, dc = jax.jit(aop.obj_and_auv_pair_cached)(
        pd, R, D, caches)
    q0 = pd.rhs - constr_sum
    trial("alm_line_search", jax.jit(alm_line_search),
          rho, dual, p1, p2, q0, t1, t2)
    trial("axpy_caches",
          jax.jit(lambda c, d: aop.axpy_caches(c, 0.5, d)), caches, dc)
    trial("primal_infeas_l1", jax.jit(aop.primal_infeas_l1),
          pd, constr_sum)


if __name__ == "__main__":
    main()
