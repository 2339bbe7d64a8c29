"""Ground-truth per-iteration cost of the ALM inner loop on the bench
problem, measured on-device by differencing two iteration budgets
(immune to dispatch overhead).

Run: PYTHONPATH=. python -u tools/profile_alm.py
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from lorads_tpu import LoradsParams
from lorads_tpu.alg import alm, aop
from lorads_tpu.alg.solver import LoradsSolver
from lorads_tpu.io import generators


def main():
    n = int(os.environ.get("PROF_N", "20000"))
    problem = generators.maxcut(n=n, avg_degree=8, seed=7)
    params = LoradsParams(verbose=False, dtype="f32")
    solver = LoradsSolver(problem, params)
    pd = solver.pd
    R = solver.R
    dual = solver.dual
    hist = solver.hist
    rho = jnp.asarray(solver.ps.rho0, pd.rhs.dtype)
    print(f"n={n} buckets={pd.n_buckets} "
          f"B={pd.buckets[0].B} Ko={pd.buckets[0].Ko} "
          f"r={R.cones[0].shape[-1]} diag_ident={pd.buckets[0].diag_ident}",
          flush=True)

    constr_sum, grad, cert = alm.alm_recompute(pd, R, dual, rho)
    dt = pd.rhs.dtype

    def run(max_local):
        out = alm.inner_chunk(
            pd, R, grad, hist, dual, constr_sum, cert, rho,
            jnp.asarray(0.0, dt), jnp.asarray(0.0, dt),
            jnp.asarray(1e-16, dt), jnp.asarray(0.0, dt),
            jnp.asarray(False), jnp.asarray(max_local, jnp.int32))
        jax.block_until_ready(out)
        return out

    for max_local in (50, 100, 200, 400):
        run(max_local)  # compile
        reps = 3
        t0 = time.time()
        for _ in range(reps):
            out = run(max_local)
        t = (time.time() - t0) / reps
        it = int(out[4]["local_iter"])
        print(f"max_local={max_local}: {t:.3f}s iters={it} "
              f"({t / max(it, 1) * 1e3:.2f} ms/iter)", flush=True)


if __name__ == "__main__":
    main()
