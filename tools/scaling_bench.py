"""Scaling-efficiency bench: iterations/s vs device count for each
sharding mode (VERDICT r1 "Next round" #2; BASELINE.md target: >= 80%
iterations/s scaling efficiency 1 -> 2+ hosts).

Runs a fixed-iteration jitted ALM inner loop (the solver's hot path:
L-BFGS direction, cached pair evaluation, exact line search, gradient,
history push — the same pieces profile_alm_bisect times) on meshes of
1/2/4/8 devices and reports iterations/s + efficiency per mode:

  dp  — cone-block axis over the mesh (many same-shape blocks)
  sp  — union-pattern sharding of one large sparse cone
  tp  — row-slab sharding of one large dense cone

Locally this runs on the VIRTUAL CPU mesh
(--xla_force_host_platform_device_count): it validates that the
collective structure scales (no serialization, no replicated-compute
blowup) and measures honest efficiency against however many physical
cores back the virtual devices.  On real multi-chip hardware the same
script measures real interconnect scaling; virtual-mesh numbers on a 4-core
host UNDERSTATE efficiency for D > cores (devices time-share cores).

Run:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
  python tools/scaling_bench.py
Env: SCALE_MODES=dp,sp,tp  SCALE_DEVS=1,2,4,8  SCALE_ITERS=24
"""

import json
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


@partial(jax.jit, static_argnames=("n_iter",))
def alm_loop(pd, R, grad, hist, dual, constr_sum, rho, n_iter):
    """n_iter full ALM inner iterations (timing body; always-update)."""

    def body(i, c):
        R_, g_, h_, ca_, cs_, acc = c
        # same carry pins as the production inner loop (alm._inner_loop)
        R_, g_ = aop.pin_factors(pd, R_), aop.pin_factors(pd, g_)
        h_ = aop.pin_history(pd, h_)
        D = lbfgs_direction(h_, g_)
        p1, t1, p2, t2, dc = aop.obj_and_auv_pair_cached(pd, R_, D, ca_)
        q0 = pd.rhs - cs_
        tau, _ = alm_line_search(rho, dual, 2 * p1, p2, q0, 2 * t1, t2)
        tau = jnp.clip(tau, -1e-3, 1e-3)
        R_ = R_.axpy(tau, D)
        cs_ = cs_ + tau * t1 + tau * tau * t2
        ca_ = aop.axpy_caches(ca_, tau, dc)
        w = rho * (cs_ - pd.rhs) - dual
        gn = aop.grad_cached(pd, R_, w, ca_)
        h_ = history_push(h_, D.scale(tau), gn + g_.scale(-1.0))
        acc = acc + jnp.sqrt(fv_norm2sq(gn))
        return (R_, gn, h_, ca_, cs_, acc)

    caches = aop.gather_caches(pd, R)
    acc = jnp.zeros((), pd.rhs.dtype)
    out = jax.lax.fori_loop(
        0, n_iter, body, (R, grad, hist, caches, constr_sum, acc))
    return out[5] + fv_norm2sq(out[0])


def make_problem(mode: str):
    if mode == "dp":
        # many same-shape blocks: the block axis shards.  Block dim is
        # tunable (SCALE_DP_DIM): scaling efficiency depends on the
        # per-device compute : collective-latency ratio.
        dim = int(os.environ.get("SCALE_DP_DIM", "48"))
        return generators.random_multiblock(n_blocks=32, dim=dim, m=64,
                                            density=0.15, seed=5)
    if mode == "sp":
        # one large sparse cone: the union pattern shards.  n/degree
        # tunable: scaling efficiency is a function of the sharded
        # pattern work (~ n*deg/2 rows) vs the REPLICATED factor-side
        # algebra (~ n*r elements — L-BFGS two-loop, line search).
        n = int(os.environ.get("SCALE_SP_N", "20000"))
        deg = int(os.environ.get("SCALE_SP_DEG", "8"))
        return generators.maxcut(n=n, avg_degree=deg, seed=7)
    # tp: one large dense cone: n x n intermediates shard by row slab
    n = int(os.environ.get("SCALE_TP_N", "500"))
    return generators.lovasz_theta(n=n, avg_degree=12, seed=9)


def time_mode(mode: str, dev_counts, n_iter: int):
    problem = make_problem(mode)
    rows = []
    for nd in dev_counts:
        params = LoradsParams(verbose=False, dtype="f32",
                              shard="off" if nd == 1 else mode,
                              n_devices=nd)
        solver = LoradsSolver(problem, params)
        if nd > 1 and solver.mesh is None:
            raise RuntimeError(f"{mode} did not activate at {nd} devices")
        pd, R, dual, hist = solver.pd, solver.R, solver.dual, solver.hist
        rho = jnp.asarray(solver.ps.rho0, pd.rhs.dtype)
        _, constr_sum = jax.jit(aop.auv)(pd, R, R)
        w = rho * (constr_sum - pd.rhs) - dual
        grad = jax.jit(aop.grad)(pd, R, w)

        def run(eps, n):
            return alm_loop(pd, R.scale(1.0 + eps), grad, hist, dual,
                            constr_sum, rho, n)

        # warm both iteration counts, then difference them so compile
        # + fixed dispatch overhead cancels
        float(run(0.0, n_iter))
        float(run(0.0, 3 * n_iter))
        ts = []
        for n in (n_iter, 3 * n_iter):
            t0 = time.time()
            for i in range(3):
                float(run(1e-7 * (i + 1), n))
            ts.append((time.time() - t0) / 3)
        per_iter = (ts[1] - ts[0]) / (2 * n_iter)
        rows.append({"devices": nd, "ms_per_iter": per_iter * 1e3,
                     "iters_per_s": 1.0 / per_iter})
    base = rows[0]["iters_per_s"]
    for r in rows:
        r["speedup"] = r["iters_per_s"] / base
        # strong-scaling efficiency: speedup / ideal(=D)
        r["efficiency"] = r["speedup"] / r["devices"]
    return rows


def pinned_probe(mode="dp", dev_counts=(1, 2), n_iter=24, repeats=2,
                 extra_env=None):
    """Strong scaling with CONSTANT RESOURCES PER DEVICE.

    The in-process virtual-mesh probe time-shares every physical core
    among all virtual devices, and its 1-device baseline already uses
    every core through XLA:CPU intra-op threading — so on a shared
    host, adding devices cannot show a speedup even when the sharded
    program partitions compute perfectly.  This probe instead runs
    each device count in its own subprocess pinned (taskset) to
    exactly one physical core per device; the cross-config efficiency
    rate(D) / (D * rate(1)) is then the honest virtual-mesh analogue
    of per-chip scaling efficiency on real hardware.

    Returns {n_devices: iters_per_s} (best of `repeats` runs per
    config), or None if taskset/cores are unavailable.
    """
    import shutil
    import subprocess
    import sys

    if shutil.which("taskset") is None:
        return None
    cores = os.cpu_count() or 1
    counts = [d for d in dev_counts if d <= cores]
    if len(counts) < 2:
        return None
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rates = {}
    for nd in counts:
        env = dict(os.environ)
        env.update({
            "XLA_FLAGS": f"--xla_force_host_platform_device_count={nd}",
            "JAX_PLATFORMS": "cpu",
            "SCALE_MODES": mode,
            "SCALE_DEVS": str(nd),
            "SCALE_ITERS": str(n_iter),
        })
        env.update(extra_env or {})
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in [repo_root, env.get("PYTHONPATH", "")] if p)
        cpu_list = ",".join(str(i) for i in range(nd))
        done = 0
        attempts = 0
        while done < repeats and attempts < 2 * repeats + 2:
            attempts += 1
            # load gating (round 5): ambient load steals the pinned
            # cores and UNDERSTATES efficiency (measured: 0.63 loaded
            # vs 0.85 idle on sp deg-8) — wait briefly for quiet, and
            # retry runs that raced a load spike
            for _ in range(12):
                if os.getloadavg()[0] < 0.8:
                    break
                time.sleep(5)
            load0 = os.getloadavg()[0]
            out = subprocess.run(
                ["taskset", "-c", cpu_list, sys.executable,
                 os.path.abspath(__file__)],
                env=env, capture_output=True, text=True, timeout=1200)
            got = False
            for line in out.stdout.splitlines():
                if line.startswith("{"):
                    r = json.loads(line)
                    rates[nd] = max(rates.get(nd, 0.0), r["iters_per_s"])
                    got = True
            # a run that STARTED quiet counts; one that raced a load
            # spike is retried (its rate still enters the max — honest
            # measurements can only be understated by contamination)
            if got and (load0 < 0.8 or attempts >= 2 * repeats):
                done += 1
    return rates if len(rates) >= 2 else None


def pinned_dp_probe(dev_counts=(1, 2), dim=96, n_iter=24, repeats=2):
    """dp pinned probe at a tunable block dim (see pinned_probe)."""
    return pinned_probe("dp", dev_counts, n_iter, repeats,
                        extra_env={"SCALE_DP_DIM": str(dim)})


def pinned_sp_probe(dev_counts=(1, 2), n=20000, deg=8, n_iter=24,
                    repeats=2):
    """sp pinned probe at a tunable Max-Cut size/degree (see
    pinned_probe).  Efficiency depends on the sharded-pattern :
    replicated-factor work ratio ~ deg/(2r)."""
    return pinned_probe("sp", dev_counts, n_iter, repeats,
                        extra_env={"SCALE_SP_N": str(n),
                                   "SCALE_SP_DEG": str(deg)})


def pinned_tp_probe(dev_counts=(1, 2), n=500, n_iter=24, repeats=2):
    """tp pinned probe at a tunable theta dim (see pinned_probe)."""
    return pinned_probe("tp", dev_counts, n_iter, repeats,
                        extra_env={"SCALE_TP_N": str(n)})


def main():
    modes = os.environ.get("SCALE_MODES", "dp,sp,tp").split(",")
    devs = [int(x) for x in
            os.environ.get("SCALE_DEVS", "1,2,4,8").split(",")]
    n_iter = int(os.environ.get("SCALE_ITERS", "24"))
    devs = [d for d in devs if d <= len(jax.devices())]
    cores = os.cpu_count()
    print(f"# backend={jax.default_backend()} devices={len(jax.devices())}"
          f" physical_cores={cores}", flush=True)
    out = {}
    for mode in modes:
        rows = time_mode(mode, devs, n_iter)
        out[mode] = rows
        for r in rows:
            print(json.dumps({"mode": mode, **{k: (round(v, 4)
                  if isinstance(v, float) else v)
                  for k, v in r.items()}}), flush=True)
    # strong-scaling efficiency note: on a virtual mesh with fewer
    # physical cores than devices, eff at D > cores is a lower bound
    for mode, rows in out.items():
        per_dev = {r["devices"]: r["efficiency"] for r in rows}
        print(f"# {mode}: efficiency "
              + " ".join(f"{d}dev={e:.2f}" for d, e in per_dev.items()),
              flush=True)


if __name__ == "__main__":
    main()
