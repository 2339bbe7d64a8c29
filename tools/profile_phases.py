"""Phase/kernels timing harness.

Times the jitted building blocks (A-pass, gradient, ALM inner chunk,
ADMM chunk) on the current backend with block_until_ready, separating
compile from steady-state.  Run on the GPU (ambient env) or the CPU
(JAX_PLATFORMS=cpu).
"""

import time

import jax
import jax.numpy as jnp

from lorads_tpu import LoradsParams
from lorads_tpu.alg import alm as alm_mod
from lorads_tpu.alg import aop
from lorads_tpu.alg.solver import LoradsSolver
from lorads_tpu.io import generators


def timeit(name, fn, reps=5):
    out = fn()
    jax.block_until_ready(out)      # compile + first run
    t0 = time.time()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.time() - t0) / reps
    print(f"{name:>28}: {dt * 1e3:9.3f} ms")
    return dt


def main():
    import os

    n = int(os.environ.get("PROF_N", "20000"))
    problem = generators.maxcut(n=n, avg_degree=8, seed=7)
    params = LoradsParams(verbose=False, dtype="f32")
    s = LoradsSolver(problem, params)
    pd, R, dual = s.pd, s.R, s.dual
    rho = jnp.asarray(2.0, s.dtype)
    print(f"backend={jax.default_backend()} n={n} "
          f"rank={s.ranks} nnz={pd.buckets[0].nnz_a}")

    timeit("A(RR^T) pass", lambda: aop.auv(pd, R, R)[1])
    _, total = aop.auv(pd, R, R)
    w = rho * (total - pd.rhs) - dual
    timeit("gradient 2(C+A*(w))R", lambda: aop.grad(pd, R, w))
    timeit("line-search pair eval",
           lambda: aop.obj_and_auv_pair(pd, R, R))

    # ALM inner chunk: 50 L-BFGS iterations
    grad = aop.grad(pd, R, w)
    hist = s.hist
    args = (pd, R, grad, hist, dual, total,
            jnp.asarray(1e3, s.dtype), rho, jnp.asarray(1e-10, s.dtype),
            jnp.asarray(1e-10, s.dtype), jnp.asarray(1e-16, s.dtype),
            jnp.asarray(1e-3, s.dtype), jnp.asarray(False),
            jnp.asarray(50, jnp.int32))
    dt = timeit("ALM inner chunk (50 it)",
                lambda: alm_mod.inner_chunk(*args)[0], reps=3)
    print(f"{'per ALM iteration':>28}: {dt / 50 * 1e3:9.3f} ms")

    # ADMM chunk of 5 iterations
    from lorads_tpu.alg import admm as admm_mod
    locals_, lp_contrib, tot, packed = admm_mod.admm_init_eval(
        pd, s.U, s.V, dual, jnp.asarray(1.0, s.dtype))
    dtt = s.dtype
    pobj, dobj, pinf, gap = (packed[0].astype(dtt),
                             packed[1].astype(dtt),
                             packed[2].astype(dtt),
                             packed[3].astype(dtt))
    chunk = admm_mod.make_admm_chunk(params, False)

    def admm5():
        return chunk(pd, s.U, s.V, locals_, lp_contrib, tot, dual,
                     jnp.asarray(2.0, dtt), jnp.asarray(5000.0, dtt),
                     jnp.zeros((10,), dtt), jnp.asarray(1e30, dtt),
                     jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
                     pinf, gap, pobj, dobj, jnp.asarray(1.0, dtt),
                     jnp.asarray(10**9, jnp.int32),
                     jnp.asarray(5, jnp.int32),
                     gap, jnp.zeros((), jnp.int32))["constr_sum"]

    dt = timeit("ADMM chunk (5 it)", admm5, reps=3)
    print(f"{'per ADMM iteration':>28}: {dt / 5 * 1e3:9.3f} ms")


if __name__ == "__main__":
    main()
