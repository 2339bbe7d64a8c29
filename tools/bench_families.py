"""Family sweep: steady-state solve time across problem families.

Measures warm-compile + steady wall-clock for a list of (family,
param-override) combos.  Used to validate parameter-default changes
(e.g. lbfgs_list_length) against every family, not just the headline.

Run: PYTHONPATH=. python -u tools/bench_families.py \
         [--families maxcut2000,matcomp500] [--lbfgs 2,3]
"""

import argparse
import dataclasses
import os
import time

from lorads_tpu import LoradsParams
from lorads_tpu.alg.solver import LoradsSolver
from lorads_tpu.io import generators


def make_problem(name):
    if name.startswith("maxcut"):
        n = int(name[len("maxcut"):])
        return generators.maxcut(n=n, avg_degree=8 if n >= 20000 else 6,
                                 seed=7)
    if name.startswith("matcomp"):
        n = int(name[len("matcomp"):])
        return generators.matrix_completion(n1=n, n2=n, true_rank=3,
                                            frac_obs=0.12, seed=3)
    if name.startswith("theta"):
        n = int(name[len("theta"):])
        return generators.lovasz_theta(n=n, avg_degree=8, seed=5)
    raise ValueError(name)


def run(problem, params):
    warm = dataclasses.replace(params, time_sec_limit=1e9)
    t0 = time.time()
    res = LoradsSolver(problem, warm).solve()
    warm_s = time.time() - t0
    t0 = time.time()
    res = LoradsSolver(problem, params).solve()
    steady = time.time() - t0
    return steady, warm_s, res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default="maxcut2000,matcomp500")
    ap.add_argument("--lbfgs", default="2,3")
    ap.add_argument("--time-limit", type=float, default=600.0)
    args = ap.parse_args()

    for fam in args.families.split(","):
        problem = make_problem(fam)
        for L in (int(x) for x in args.lbfgs.split(",")):
            params = LoradsParams(verbose=False, dtype="auto",
                                  time_sec_limit=args.time_limit,
                                  lbfgs_list_length=L)
            steady, warm_s, res = run(problem, params)
            print(f"{fam} L={L}: steady={steady:.3f}s warm={warm_s:.1f}s "
                  f"status={res.status.value} pinf={res.pinf_l1:.2e} "
                  f"gap={res.gap:.2e}", flush=True)


if __name__ == "__main__":
    main()
