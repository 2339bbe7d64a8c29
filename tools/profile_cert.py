"""Dual-infeasibility certificate profiler (VERDICT r2 #5).

Solves one bench family, then attributes the certificate's cost:

* wall time of the full jitted certificate dispatch (steady state),
* per-bucket Lanczos restart counts (from the device loop itself),
* a host-driven restart-by-restart Ritz trajectory on the exact
  production slack operator (alg.solver._slack_operator), printing
  lam / residual / which exit rule would fire at each restart — the
  data needed to design cheaper convergence probes.

Run on the GPU (ambient env) or the CPU (JAX_PLATFORMS=cpu).
Env: PROF_FAMILY=maxcut100000 PROF_TOL=1e-2.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from bench import make_problem
from lorads_tpu import LoradsParams
from lorads_tpu.alg import solver as solver_mod
from lorads_tpu.alg.lanczos import min_ritz
from lorads_tpu.alg.solver import LoradsSolver
from lorads_tpu.ops import pattern as pat


def main():
    family = os.environ.get("PROF_FAMILY", "maxcut100000")
    tol = float(os.environ.get("PROF_TOL", "1e-2"))
    problem = make_problem(family)
    params = LoradsParams(verbose=False, time_sec_limit=1e9,
                          reopt_level=2, dtype="auto")
    s = LoradsSolver(problem, params)
    t0 = time.time()
    res = s.solve()
    print(f"backend={jax.default_backend()} family={family} "
          f"solve={time.time() - t0:.2f}s status={res.status.value} "
          f"dinf={res.dinf_l1:.3e}")

    # steady-state certificate wall (the solve already compiled it)
    for rep in range(3):
        t0 = time.time()
        lp_part, lams = s._dual_infeas_pass()
        dt = time.time() - t0
        print(f"certificate pass #{rep}: {dt * 1e3:.1f} ms, "
              f"restarts per bucket {s.last_cert_restarts} "
              f"(-1 = exact eigh)")

    # restart trajectory on each Lanczos bucket's production operator
    neg_l = -s.dual
    rng = np.random.default_rng(12)
    for i, (bk, bp) in enumerate(zip(s.pd.buckets, s.ps.buckets)):
        w_loc = jax.jit(pat.gather_w)(bk, neg_l)
        kind, op, ws_eff = solver_mod._slack_operator(bk, w_loc)
        if kind != "lanczos":
            print(f"bucket {i}: exact eigh (n={bk.n}), skipping")
            continue
        b_eff = 1 if (bk.summed or bk.rowshard) else bk.B
        v0 = rng.standard_normal((b_eff, bk.n))
        v0 *= (np.arange(bk.n)[None, :]
               < np.asarray(bp.dims)[:b_eff, None])
        v = jnp.asarray(v0, s.dtype)
        ws = np.asarray(jax.device_get(ws_eff)).reshape(-1)
        dt_f = s.dtype
        floor = 1e-4 if dt_f == jnp.float64 else 3e-3
        lam_prev = None
        step_prev = None
        print(f"bucket {i}: n={bk.n} B={b_eff} kind=lanczos "
              f"dtype={np.dtype(dt_f).name} ws_max={ws.max():.3e}")
        for r in range(1, 18):
            t0 = time.time()
            lam, v, resid = min_ritz(op, v, min(36, bk.n))
            lam_h, res_h = jax.device_get((lam, resid))
            dt = time.time() - t0
            lam_h = np.asarray(lam_h, np.float64)
            res_h = np.asarray(res_h, np.float64)
            band = tol * np.maximum(np.abs(lam_h), floor)
            pos = lam_h - res_h >= -tol * floor
            # geometric-extrapolation value exit (lanczos.py cond)
            settled = np.zeros_like(lam_h, bool)
            if lam_prev is not None:
                step = np.abs(lam_h - lam_prev)
                if step_prev is not None:
                    q = np.minimum(step / np.maximum(step_prev, 1e-30),
                                   0.9)
                    settled = (step * q / (1.0 - q)
                               <= 0.5 * tol * np.abs(lam_h))
                step_prev = step
            done = (res_h <= band) | pos | settled
            j = int(np.argmin(lam_h))  # most negative block
            print(f"  restart {r:2d}: {dt * 1e3:7.1f} ms  "
                  f"lam_min*ws={lam_h[j] * ws[min(j, ws.size - 1)]:+.6e} "
                  f"lam={lam_h[j]:+.6e} resid={res_h[j]:.3e} "
                  f"band={band[j]:.3e} "
                  f"exits: resid={bool((res_h <= band)[j])} "
                  f"pos={bool(pos[j])} settled={bool(settled[j])} "
                  f"all_done={bool(done.all())}")
            lam_prev = lam_h
            if done.all():
                break


if __name__ == "__main__":
    main()
