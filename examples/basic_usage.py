"""Basic usage: build an SDP, solve it, inspect the result.

Run:  python examples/basic_usage.py
(CPU: prefix with  JAX_PLATFORMS=cpu)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from lorads_tpu import LoradsParams, solve
from lorads_tpu.core.problem import SDPBlockData, SDPProblem
from lorads_tpu.io import generators


def from_generator():
    """Solve a G-set-style Max-Cut relaxation."""
    problem = generators.maxcut(n=500, avg_degree=6, seed=0)
    res = solve(problem, LoradsParams(verbose=False))
    print(f"maxcut n=500: {res.status.value}  pObj={res.pobj:.6e}  "
          f"gap={res.gap:.1e}  pinf={res.pinf_l1:.1e}")
    return res


def hand_built():
    """Build min <C,X> s.t. diag(X)=1, X PSD directly from triplets."""
    n = 8
    rng = np.random.default_rng(0)
    # random symmetric objective, lower triangle (row >= col)
    rows, cols = np.tril_indices(n)
    vals = rng.standard_normal(rows.size)
    blk = SDPBlockData(
        dim=n, m=n,
        obj_row=rows.astype(np.int32), obj_col=cols.astype(np.int32),
        obj_val=vals,
        a_con=np.arange(n, dtype=np.int32),     # constraint i ...
        a_row=np.arange(n, dtype=np.int32),     # ... touches X[i, i]
        a_col=np.arange(n, dtype=np.int32),
        a_val=np.ones(n),
    )
    problem = SDPProblem(m=n, rhs=np.ones(n), blocks=[blk])
    res = solve(problem, LoradsParams(verbose=False))
    X = np.asarray(res.R.cones[0][0])
    X = X @ X.T
    print(f"hand-built:   {res.status.value}  pObj={res.pobj:.6e}  "
          f"diag err={np.abs(np.diag(X) - 1).max():.1e}")
    return res


def batched():
    """Solve several same-shape instances as one vectorized batch."""
    from lorads_tpu import LoradsParams, merge_problems, split_objectives
    from lorads_tpu.alg.solver import LoradsSolver

    probs = [generators.maxcut(n=120, avg_degree=5, seed=s)
             for s in range(4)]
    solver = LoradsSolver(merge_problems(probs),
                          LoradsParams(verbose=False))
    res = solver.solve()
    xs, lp_vals = solver.x_blocks(res.R)
    objs = split_objectives(probs, xs, lp_vals)
    print("batched maxcut objectives:",
          " ".join(f"{o:.4e}" for o in objs))
    return objs


if __name__ == "__main__":
    from_generator()
    hand_built()
    batched()
