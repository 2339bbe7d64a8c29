"""Per-phase roofline report (VERDICT r1 #5).

For each bench family: lower + compile the solver's hot programs (the
full ALM inner iteration and one ADMM sweep), pull FLOPs/bytes from
XLA's compiled cost model, time the programs by iteration-count
differencing, and print wall vs speed-of-light target, MFU and
HBM-bandwidth fractions against the card's data-sheet peaks
(utils/profiling.chip_peaks; an unknown device is an error).

Run (GPU):                 python tools/roofline.py
Env: ROOF_FAMILIES=maxcut20000,theta300  ROOF_ITERS=64
"""

import os
import time

import jax
import jax.numpy as jnp

from lorads_tpu import LoradsParams
from lorads_tpu.alg import admm as admm_mod
from lorads_tpu.alg import aop
from lorads_tpu.alg.solver import LoradsSolver
from lorads_tpu.io import generators
from lorads_tpu.utils.profiling import (compiled_cost, format_roofline,
                                        roofline)
from tools.scaling_bench import alm_loop


def make_problem(fam: str):
    if fam.startswith("maxcut"):
        n = int(fam[6:])
        return generators.maxcut(n=n, avg_degree=8, seed=7)
    if fam.startswith("theta"):
        return generators.lovasz_theta(n=int(fam[5:]), avg_degree=8,
                                       seed=5)
    if fam.startswith("matcomp"):
        n = int(fam[7:])
        return generators.matrix_completion(n1=n, n2=n, true_rank=3,
                                            seed=3)
    raise ValueError(fam)


@jax.jit
def alm_iter_once(pd, R, grad, hist, dual, constr_sum, rho, caches):
    """ONE ALM inner iteration, no loop: XLA's cost model counts a
    fori_loop body once regardless of trip count, so per-iteration
    FLOPs/bytes come from this unrolled twin of alm_loop's body
    (timing still comes from loop differencing, which cancels the
    setup the twin also excludes)."""
    from lorads_tpu.alg.linesearch import alm_line_search
    from lorads_tpu.alg.state import (fv_norm2sq, history_push,
                                      lbfgs_direction)

    D = lbfgs_direction(hist, grad)
    p1, t1, p2, t2, dc = aop.obj_and_auv_pair_cached(pd, R, D, caches)
    q0 = pd.rhs - constr_sum
    tau, _ = alm_line_search(rho, dual, 2 * p1, p2, q0, 2 * t1, t2)
    tau = jnp.clip(tau, -1e-3, 1e-3)
    R = R.axpy(tau, D)
    cs = constr_sum + tau * t1 + tau * tau * t2
    ca = aop.axpy_caches(caches, tau, dc)
    w = rho * (cs - pd.rhs) - dual
    gn = aop.grad_cached(pd, R, w, ca)
    hist = history_push(hist, D.scale(tau), gn + grad.scale(-1.0))
    return jnp.sqrt(fv_norm2sq(gn)) + aop.primal_infeas_l1(pd, cs)


@jax.jit
def admm_sweep(pd, U, V, locals_, total, dual, rho):
    out = admm_mod.admm_update_all(
        pd, U, V, locals_, jnp.zeros_like(total), total, dual, rho,
        jnp.asarray(1e-8, pd.rhs.dtype), 20)
    return out[0], out[1], out[4]


def report(fam: str, n_iter: int, dtype: str):
    problem = make_problem(fam)
    solver = LoradsSolver(problem, LoradsParams(verbose=False,
                                                dtype=dtype))
    pd, R, dual, hist = solver.pd, solver.R, solver.dual, solver.hist
    dt_name = "f64" if pd.rhs.dtype == jnp.float64 else "f32"
    rho = jnp.asarray(solver.ps.rho0, pd.rhs.dtype)
    _, cs = jax.jit(aop.auv)(pd, R, R)
    grad = jax.jit(aop.grad)(pd, R, rho * (cs - pd.rhs) - dual)
    print(f"== {fam}  (n_iter {n_iter}, dtype {dt_name}, "
          f"rank {solver.ranks})")

    # ALM inner iteration: FLOPs/bytes from the unrolled single-iter
    # twin (XLA counts a loop body once); wall from loop differencing
    # (cancels dispatch + setup overhead).
    caches = jax.jit(aop.gather_caches)(pd, R)
    cost = compiled_cost(
        alm_iter_once.lower(pd, R, grad, hist, dual, cs, rho,
                            caches).compile())
    compiled = {n: alm_loop.lower(pd, R, grad, hist, dual, cs, rho,
                                  n).compile()
                for n in (n_iter, 5 * n_iter)}
    args = (pd, R, grad, hist, dual, cs, rho)
    for c in compiled.values():
        float(c(*args))                      # warm
    # median of paired diffs: dispatch jitter swamps a single
    # short-minus-long difference on small problems
    diffs = []
    for _ in range(5):
        t0 = time.time()
        float(compiled[n_iter](*args))
        t1 = time.time()
        float(compiled[5 * n_iter](*args))
        t2 = time.time()
        diffs.append(((t2 - t1) - (t1 - t0)) / (4 * n_iter))
    per_iter = sorted(diffs)[len(diffs) // 2]
    r = roofline(cost["flops"], cost["bytes"], per_iter, dtype=dt_name)
    print(format_roofline("ALM iteration", r))

    # one ADMM sweep (U+V updates via CG/closed form + dual refresh)
    locals_, total = jax.jit(aop.auv)(pd, solver.U, solver.V)
    low = admm_sweep.lower(pd, solver.U, solver.V, locals_, total,
                           dual, rho)
    comp = low.compile()
    c1 = compiled_cost(comp)
    args = (pd, solver.U, solver.V, locals_, total, dual, rho)
    jax.block_until_ready(comp(*args))
    t0 = time.time()
    for _ in range(5):
        out = comp(*args)
    jax.device_get(out[2])
    wall = (time.time() - t0) / 5
    r2 = roofline(c1["flops"], c1["bytes"], wall, dtype=dt_name)
    print(format_roofline("ADMM sweep (1 iter)", r2))
    return r, r2


def main():
    fams = os.environ.get("ROOF_FAMILIES",
                          "maxcut20000,theta300,maxcut100000").split(",")
    n_iter = int(os.environ.get("ROOF_ITERS", "64"))
    dtype = os.environ.get("ROOF_DTYPE", "f32")
    print(f"# backend={jax.default_backend()} "
          f"device={jax.devices()[0].device_kind}")
    for fam in fams:
        report(fam, n_iter, dtype)


if __name__ == "__main__":
    main()
