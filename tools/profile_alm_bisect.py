"""Bisect the 10x loop-context penalty: build fori_loop bodies from
subsets of the ALM inner-iteration pieces and difference iteration
counts.  Always-update (no lax.cond), fixed small tau when the line
search is ablated — timing only, not convergence.

Run: PYTHONPATH=. python -u tools/profile_alm_bisect.py
"""

import os
import time
from functools import partial

import jax
import jax.numpy as jnp

from lorads_tpu import LoradsParams
from lorads_tpu.alg import aop
from lorads_tpu.alg.linesearch import alm_line_search
from lorads_tpu.alg.solver import LoradsSolver
from lorads_tpu.alg.state import fv_norm2sq, history_push, lbfgs_direction
from lorads_tpu.io import generators

ALL = ("dir", "pair", "search", "upd", "grad", "push", "cert")


@partial(jax.jit, static_argnames=("flags", "n_iter"))
def run_loop(pd, R, grad, hist, dual, constr_sum, rho, flags, n_iter):
    fl = set(flags)
    dt = pd.rhs.dtype

    def body(i, c):
        R_, g_, h_, ca_, cs_, acc = c
        D = lbfgs_direction(h_, g_) if "dir" in fl else g_.scale(-1.0)
        if "pair" in fl:
            p1, t1, p2, t2, dc = aop.obj_and_auv_pair_cached(
                pd, R_, D, ca_)
        else:
            p1 = p2 = jnp.zeros((), dt)
            t1 = t2 = jnp.zeros_like(cs_)
            dc = ca_
        if "search" in fl:
            q0 = pd.rhs - cs_
            tau, _ = alm_line_search(rho, dual, 2 * p1, p2, q0,
                                     2 * t1, t2)
            tau = jnp.clip(tau, -1e-3, 1e-3)
        else:
            tau = jnp.asarray(1e-3, dt) + 1e-20 * p1
        if "upd" in fl:
            R_ = R_.axpy(tau, D)
            cs_ = cs_ + tau * t1 + tau * tau * t2
            ca_ = aop.axpy_caches(ca_, tau, dc)
        if "grad" in fl:
            w = rho * (cs_ - pd.rhs) - dual
            gn = aop.grad_cached(pd, R_, w, ca_)
        else:
            gn = g_
        if "push" in fl:
            h_ = history_push(h_, D.scale(tau), gn + g_.scale(-1.0))
        if "cert" in fl:
            acc = acc + jnp.sqrt(fv_norm2sq(gn)) + aop.primal_infeas_l1(
                pd, cs_)
        return (R_, gn, h_, ca_, cs_, acc)

    caches = aop.gather_caches(pd, R)
    acc = jnp.zeros((), dt)
    out = jax.lax.fori_loop(
        0, n_iter, body, (R, grad, hist, caches, constr_sum, acc))
    return out[5] + fv_norm2sq(out[0])


def main():
    n = int(os.environ.get("PROF_N", "20000"))
    problem = generators.maxcut(n=n, avg_degree=8, seed=7)
    params = LoradsParams(verbose=False, dtype="f32")
    solver = LoradsSolver(problem, params)
    pd, R, dual, hist = solver.pd, solver.R, solver.dual, solver.hist
    dt = pd.rhs.dtype
    rho = jnp.asarray(solver.ps.rho0, dt)
    _, constr_sum = jax.jit(aop.auv)(pd, R, R)
    w = rho * (constr_sum - pd.rhs) - dual
    grad = jax.jit(aop.grad)(pd, R, w)

    def timed(flags):
        ts = []
        for n_iter in (64, 192):
            f = lambda eps: run_loop(pd, R.scale(1.0 + eps), grad, hist,
                                     dual, constr_sum, rho, flags,
                                     n_iter)
            jax.block_until_ready(f(0.0))
            t0 = time.time()
            for i in range(3):
                jax.block_until_ready(f(1e-7 * (i + 1)))
            ts.append((time.time() - t0) / 3)
        print(f"    [{','.join(flags) or 'none'}] 64it={ts[0]:.3f}s "
              f"192it={ts[1]:.3f}s", flush=True)
        return (ts[1] - ts[0]) / 128 * 1e3

    base = timed(ALL)
    print(f"{'FULL':>28}: {base:7.3f} ms/iter", flush=True)
    for drop in ALL:
        flags = tuple(x for x in ALL if x != drop)
        ms = timed(flags)
        print(f"{'-' + drop:>28}: {ms:7.3f} ms/iter "
              f"(delta {base - ms:+.3f})", flush=True)
    for only in ("pair", "grad"):
        flags = (only, "upd")
        ms = timed(flags)
        print(f"{'only ' + only + '+upd':>28}: {ms:7.3f} ms/iter",
              flush=True)


if __name__ == "__main__":
    main()
