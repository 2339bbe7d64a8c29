"""Bring-up smoke test of the solve path on NVIDIA GPUs.

    python chip_smoke.py           # one GPU: phases 0, 1 and 2
    python chip_smoke.py --multi   # four GPUs: sharded solves only

Run from the repository root.  One process drives the card(s); the
only child process is ``nvidia-smi``.

Phase 0 checks that JAX runs on a GPU and prints the card, its power
limit and the compile-cache directory.  Phase 1 runs every kernel of
the solve path as compiled for the card, at f32 and f64, on the Max-Cut
n=20000 pattern and the Lovasz-theta n=300 dense block, and compares
each with a NumPy float64 oracle; it also times the compensated
segment sum against XLA's sorted segment sum and the plain cumsum
route.  Phase 2 solves five instances through the CLI entry point
(``lorads_tpu.__main__.main``) with ``--solOut`` and verifies each
exported solution independently in NumPy/SciPy.  ``--multi`` solves
three instances with ``--shard dp/sp/tp`` over four cards and compares
each with the same instance solved on one card, both at f64.

Any failure raises: the exit code is non-zero and no JSON line is
printed.  On success the last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
PHASE2_TOL = 1e-5

# Instance sizes.  A CPU rehearsal shrinks these; the defaults are the
# sizes the smoke test claims.
SIZES = {
    "maxcut_kernels": dict(n=20000, avg_degree=8, seed=7),
    "phase2_maxcut": dict(n=20000, avg_degree=8, seed=7),
    "phase2_maxcut_large": dict(n=100000, avg_degree=10, seed=7),
    "multiblock": [dict(n_blocks=3, dim=40, m=60, n_lp=0, seed=11),
                   dict(n_blocks=2, dim=90, m=60, n_lp=8, seed=12)],
    "multi_dp": dict(n_blocks=8, dim=60, m=80, seed=21),
    "multi_sp": dict(n=200000, avg_degree=10, seed=7),
    "multi_tp": dict(n=800, avg_degree=8, seed=5),
    "timing_reps": 20,
}

# Per-dtype tolerances of the kernel comparisons (Phase 1).  Every
# error is measured elementwise against the sum of the absolute values
# of the terms that make the output ("absref"), the scale that rounding
# error grows with.  f64 compensated sums may also carry 2^-47 of the
# running prefix (pattern.comp_segment_sum's contract); x8 margin.
RTOL = {"float32": 1e-5, "float64": 1e-12}
RTOL_COMP64 = 1e-11
PREFIX_TERM = 8 * 2.0 ** -47


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 0: the device.
# ---------------------------------------------------------------------------

def require_gpu(n: int = 1):
    """The GPU backend with at least ``n`` devices, or raise.  JAX
    falls back to the CPU with only a warning when its CUDA plugin
    fails to load, so every phase calls this."""
    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    devs = jax.devices()
    if len(devs) < n:
        raise RuntimeError(f"need {n} GPUs, JAX sees {len(devs)}")
    return devs


def phase0(n_devices: int):
    import jax

    devs = require_gpu(n_devices)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"[phase0] jax {jax.__version__}, {len(devs)} x "
        f"{devs[0].device_kind}")
    for line in smi.stdout.strip().splitlines():
        log(f"[phase0] nvidia-smi: {line.strip()}")
    log(f"[phase0] compile cache: {jax.config.jax_compilation_cache_dir}")
    log(f"[phase0] matmul precision: "
        f"{jax.config.jax_default_matmul_precision}")
    return devs


def check_no_tf32():
    """An f32 matrix product under the package's settings keeps full
    f32 accuracy: TF32 would fail the 1e-5 bound."""
    import jax
    import jax.numpy as jnp

    import lorads_tpu  # noqa: F401  (sets the matmul precision)

    rng = np.random.default_rng(0)
    a = rng.standard_normal((1024, 1024))
    b = rng.standard_normal((1024, 1024))
    got = np.asarray(jax.jit(jnp.matmul)(jnp.asarray(a, jnp.float32),
                                         jnp.asarray(b, jnp.float32)))
    a32 = a.astype(np.float32).astype(np.float64)
    b32 = b.astype(np.float32).astype(np.float64)
    ratio = np.max(np.abs(got - a32 @ b32) / (np.abs(a32) @ np.abs(b32)))
    log(f"[phase1] f32 matmul vs f64 oracle: max err/absref {ratio:.2e}")
    if not ratio <= RTOL["float32"]:
        raise AssertionError(f"f32 matmul error {ratio:.2e} > 1e-5: "
                             "TF32 or reduced precision is active")


# ---------------------------------------------------------------------------
# Phase 1: kernels against NumPy float64 oracles.
# ---------------------------------------------------------------------------

def compare(name, got, ref, absref, dtype, comp=False, rtol=None):
    """Elementwise |got - ref| <= rtol * absref (+ the prefix term of a
    compensated f64 sum, cumulated along axis 0).  ``rtol`` defaults
    to the dtype's RTOL.  Returns the worst error-to-bound ratio;
    raises if it exceeds 1."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    absref = np.maximum(np.asarray(absref, np.float64), 1e-300)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: non-finite output")
    dt = np.dtype(dtype).name
    if rtol is not None:
        bound = rtol * absref
    elif dt == "float64" and comp:
        bound = (RTOL_COMP64 * absref
                 + PREFIX_TERM * np.cumsum(absref, axis=0))
    else:
        bound = RTOL[dt] * absref
    ratio = float(np.max(np.abs(got - ref) / bound))
    log(f"[phase1] {name:<34} {dt:<8} err/bound {ratio:.3f}")
    if not ratio <= 1.0:
        raise AssertionError(f"{name} at {dt}: error exceeds bound "
                             f"(ratio {ratio:.3f})")
    return ratio


def _entry_terms(rows, cols, vals, F):
    """Per-entry terms of <M, F F^T> for a symmetric M given by its
    lower-triangle COO list (off-diagonal entries count twice)."""
    return (vals * np.where(rows == cols, 1.0, 2.0)
            * np.einsum("kr,kr->k", F[rows], F[cols]))


def oracle_auv(problem, blk, R):
    """A(R R^T) for one block and its absolute-term sums."""
    r, c, v = blk.a_row, blk.a_col, blk.a_val
    m = problem.m
    return (np.bincount(blk.a_con, weights=_entry_terms(r, c, v, R),
                        minlength=m),
            np.bincount(blk.a_con, minlength=m,
                        weights=_entry_terms(r, c, np.abs(v), np.abs(R))))


def _sym_apply(rows, cols, vals, X, n):
    """(S X) for the symmetric matrix given by its lower-triangle COO."""
    out = np.zeros((n, X.shape[1]))
    np.add.at(out, rows, vals[:, None] * X[cols])
    off = rows != cols
    np.add.at(out, cols[off], vals[off, None] * X[rows[off]])
    return out


def oracle_grad(blk, R, w):
    """2 (C + sum_i w_i A_i) R and its absolute-term sums."""
    rows = np.concatenate([blk.obj_row, blk.a_row])
    cols = np.concatenate([blk.obj_col, blk.a_col])
    vals = np.concatenate([blk.obj_val, w[blk.a_con] * blk.a_val])
    n = blk.dim
    return (2.0 * _sym_apply(rows, cols, vals, R, n),
            2.0 * _sym_apply(rows, cols, np.abs(vals), np.abs(R), n))


def slack_dense(blk, y):
    """Dense C - sum_i y_i A_i of one block."""
    S = np.zeros((blk.dim, blk.dim))
    np.add.at(S, (blk.obj_row, blk.obj_col), blk.obj_val)
    np.add.at(S, (blk.a_row, blk.a_col), -y[blk.a_con] * blk.a_val)
    return S + S.T - np.diag(np.diag(S))


def _kernel_setup(problem, dtype, seed):
    import jax.numpy as jnp

    from lorads_tpu.alg import aop
    from lorads_tpu.alg.state import FactorVec
    from lorads_tpu.config import LoradsParams
    from lorads_tpu.core.presolve import presolve

    ps = presolve(problem, LoradsParams(), group=True)
    pd = aop.build_problem_data(ps, dtype)
    bp = ps.buckets[0]
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((bp.n, bp.rank))
    R[problem.blocks[0].dim:] = 0.0
    w = rng.standard_normal(problem.m)
    Rj = FactorVec((jnp.asarray(R[None], dtype),), jnp.zeros((0,), dtype))
    return pd, R, w, Rj


def _rounded(x, dtype):
    """x as the kernel sees it (f32 inputs are rounded first)."""
    return np.asarray(np.asarray(x, dtype), np.float64)


def kernels_maxcut(problem, dtype):
    """auv, grad (cmul + diagonal adjoint) and comp_segment_sum at the
    Max-Cut pattern, plus the certificate's Lanczos on its slack."""
    import jax
    import jax.numpy as jnp

    from lorads_tpu.alg import aop
    from lorads_tpu.alg.lanczos import lanczos_min_eig_device
    from lorads_tpu.alg.solver import _slack_operator
    from lorads_tpu.ops import pattern as pat

    blk = problem.blocks[0]
    tag = f"maxcut{blk.dim}"
    pd, R, w, Rj = _kernel_setup(problem, dtype, seed=1)
    R64, w64 = _rounded(R, dtype), _rounded(w, dtype)
    n = blk.dim
    _, total = jax.jit(aop.auv)(pd, Rj, Rj)
    ref, absref = oracle_auv(problem, blk, R64[:n])
    compare(f"{tag} auv (constraint values)", total, ref, absref,
            dtype, comp=True)
    g = jax.jit(aop.grad)(pd, Rj, jnp.asarray(w, dtype)).cones[0][0, :n]
    ref, absref = oracle_grad(blk, R64[:n], w64)
    compare(f"{tag} grad (cmul + adjoint)", g, ref, absref, dtype,
            comp=True)

    bk = pd.buckets[0]
    data = jax.jit(lambda bk, X: bk.c_sym_rs[:, :, None]
                   * pat.take_rows(X, bk.sym_cols_rs))(bk, Rj.cones[0])
    data64 = np.asarray(data, np.float64)[0]
    ids = np.asarray(bk.sym_rows_rs)[0]
    got = jax.jit(pat.comp_segment_sum)(data, bk.bnd_sym_rows)[0]
    ref = np.zeros((bk.n, data64.shape[1]))
    np.add.at(ref, ids, data64)
    absref = np.zeros_like(ref)
    np.add.at(absref, ids, np.abs(data64))
    compare(f"{tag} comp_segment_sum", got, ref, absref, dtype,
            comp=True)

    # Lanczos on the normalized slack (C - A^*(y)) / ws at a small
    # random y with one spike, so lambda_min is well separated and the
    # restarted sweep converges to the requested tolerance
    y = 0.1 * np.random.default_rng(2).standard_normal(problem.m)
    y[np.argmax(problem.blocks[0].a_con == 0)] += 20.0
    tol = 1e-10 if np.dtype(dtype) == np.float64 else 1e-5

    @jax.jit
    def lanczos(bk, y, v0):
        _, mv, ws = _slack_operator(bk, pat.gather_w(bk, -y))
        lam, _ = lanczos_min_eig_device(mv, v0, tol=tol)
        return lam * ws

    v0 = np.random.default_rng(3).standard_normal((1, bk.n))
    lam = float(lanczos(bk, jnp.asarray(y, dtype),
                        jnp.asarray(v0, dtype))[0])
    S = _slack_sparse(blk, _rounded(y, dtype))
    lam_ref = _min_eig_sparse(S)
    nrm = float(abs(S).sum(axis=1).max())        # >= ||S||_2
    compare(f"{tag} lanczos_min_eig_device", [lam], [lam_ref],
            [nrm], dtype, rtol=max(tol, RTOL[np.dtype(dtype).name]))


def kernels_theta(problem, dtype):
    """auv, grad, the dense uvt einsum, one batched CG solve, Lanczos
    and the exact eigh certificate on the theta300 dense block."""
    import jax
    import jax.numpy as jnp

    from lorads_tpu.alg import aop
    from lorads_tpu.alg.cg import cg_solve
    from lorads_tpu.alg.lanczos import lanczos_min_eig_device
    from lorads_tpu.alg.solver import _exact_min_eig, _slack_operator
    from lorads_tpu.ops import pattern as pat

    blk = problem.blocks[0]
    pd, R, w, Rj = _kernel_setup(problem, dtype, seed=4)
    bk = pd.buckets[0]
    if not bk.dense:
        raise AssertionError("theta300 is expected in dense mode")
    n = blk.dim
    R64, w64 = _rounded(R, dtype), _rounded(w, dtype)
    _, total = jax.jit(aop.auv)(pd, Rj, Rj)
    ref, absref = oracle_auv(problem, blk, R64[:n])
    compare("theta300 auv (constraint values)", total, ref, absref,
            dtype, comp=True)
    g = jax.jit(aop.grad)(pd, Rj, jnp.asarray(w, dtype)).cones[0][0, :n]
    ref, absref = oracle_grad(blk, R64[:n], w64)
    compare("theta300 grad (build_w + w_mul)", g, ref, absref, dtype,
            comp=True)

    rng = np.random.default_rng(5)
    V = rng.standard_normal(R.shape)
    V[n:] = 0.0
    V64 = _rounded(V, dtype)
    got = jax.jit(pat.uvt)(bk, Rj.cones[0], jnp.asarray(V[None], dtype))
    ref = 0.5 * (R64 @ V64.T + V64 @ R64.T)
    absref = 0.5 * (np.abs(R64) @ np.abs(V64).T
                    + np.abs(V64) @ np.abs(R64).T)
    compare("theta300 uvt (dense einsum)", got[0], ref, absref, dtype)

    # one batched CG solve of the ADMM operator x + A^*(A(sym(x F^T))) F
    F = jnp.asarray(V[None], dtype)
    b = rng.standard_normal(R.shape)
    b[n:] = 0.0
    cg_tol = 1e-14 if np.dtype(dtype) == np.float64 else 1e-8

    @jax.jit
    def cg(bk, F, b):
        def op(x):
            vals = pat.constr_vals(bk, pat.uvt(bk, x, F))
            return x + pat.w_mul(bk, pat.build_w(bk, vals,
                                                 include_obj=False), F)
        return cg_solve(op, jnp.zeros_like(b), b, cg_tol, 3000)

    x, iters = cg(bk, F, jnp.asarray(b[None], dtype))
    x64 = np.asarray(x, np.float64)[0, :n]
    # oracle operator L = I + G^T G with G_i = vec(A_i F)
    F64, r = V64[:n], V.shape[1]
    G = np.zeros((problem.m, n * r))
    for i in range(problem.m):
        G[i] = (blk.dense_constr(i) @ F64).ravel()
    L = np.eye(n * r) + G.T @ G
    b64 = _rounded(b, dtype)[:n].ravel()
    resid = b64 - L @ x64.ravel()
    absref = np.abs(b64) + np.abs(L) @ np.abs(x64.ravel())
    log(f"[phase1] theta300 cg_solve iterations: {int(iters)}")
    compare("theta300 cg_solve (true residual)", resid, 0 * resid,
            absref, dtype)

    # C = -J makes lambda_min ~ -n, well separated, at a small y
    y = 0.1 * rng.standard_normal(problem.m)
    y64 = _rounded(y, dtype)
    kind, Wn, ws = _slack_operator(bk, pat.gather_w(bk, -jnp.asarray(
        y, dtype)))
    if kind != "eigh":
        raise AssertionError("theta300 slack should take the eigh path")
    S = slack_dense(blk, y64)
    ev_ref = np.linalg.eigvalsh(S)
    nrm = float(np.max(np.abs(ev_ref)))
    lam_k, _ = jax.jit(_exact_min_eig)(Wn)
    k = lam_k.shape[1]
    got = np.asarray(lam_k, np.float64)[0] * float(ws[0])
    compare("theta300 _exact_min_eig", got, ev_ref[:k],
            np.full(k, nrm), dtype)

    tol = 1e-10 if np.dtype(dtype) == np.float64 else 1e-5

    @jax.jit
    def lanczos(Wn, v0):
        mv = lambda x: pat.w_mul(bk, Wn, x[:, :, None])[:, :, 0]
        lam, _ = lanczos_min_eig_device(mv, v0, tol=tol)
        return lam

    v0 = rng.standard_normal((1, bk.n))
    v0[:, n:] = 0.0
    lam = float(lanczos(Wn, jnp.asarray(v0, dtype))[0]) * float(ws[0])
    compare("theta300 lanczos_min_eig_device", [lam], ev_ref[:1],
            [nrm], dtype, rtol=max(tol, RTOL[np.dtype(dtype).name]))


def time_segment_sums(problem, reps: int):
    """Device time of the three sorted segment-sum routes at the
    Max-Cut cmul shapes ([1, 2 Ko, r] rows into [1, n, r])."""
    import jax
    import jax.numpy as jnp

    from lorads_tpu.ops import pattern as pat

    for dtype in (jnp.float32, jnp.float64):
        pd, _, _, Rj = _kernel_setup(problem, dtype, seed=6)
        bk = pd.buckets[0]
        data = (bk.c_sym_rs[:, :, None]
                * pat.take_rows(Rj.cones[0], bk.sym_cols_rs))
        ids = bk.sym_rows_rs
        routes = {
            "comp_segment_sum": jax.jit(pat.comp_segment_sum),
            "jax.ops.segment_sum(sorted)": jax.jit(
                lambda d, i: jax.ops.segment_sum(
                    d[0], i[0], num_segments=bk.n,
                    indices_are_sorted=True)[None]),
            "bounded_segment_sum": jax.jit(pat.bounded_segment_sum),
        }
        name = jnp.dtype(dtype).name
        for route, fn in routes.items():
            arg = ids if route.startswith("jax.ops") else bk.bnd_sym_rows
            fn(data, arg).block_until_ready()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(data, arg).block_until_ready()
                ts.append(time.perf_counter() - t0)
            ms = 1e3 * float(np.median(ts))
            log(f"[phase1] segment-sum timing {route:<28} {name:<8} "
                f"median {ms:.4f} ms over {reps} (rows {data.shape[1]},"
                f" r {data.shape[2]}, segments {bk.n})")


def phase1():
    import jax.numpy as jnp

    from lorads_tpu.io import generators
    from lorads_tpu.io.sdpa import read_sdpa

    require_gpu()
    check_no_tf32()
    maxcut = generators.maxcut(**SIZES["maxcut_kernels"])
    theta = read_sdpa(os.path.join(FIXTURES, "theta300.dat-s"))
    for dtype in (jnp.float32, jnp.float64):
        kernels_maxcut(maxcut, dtype)
        kernels_theta(theta, dtype)
    time_segment_sums(maxcut, SIZES["timing_reps"])


# ---------------------------------------------------------------------------
# Independent solution verification (NumPy / SciPy only).
# ---------------------------------------------------------------------------

def _slack_sparse(blk, y):
    import scipy.sparse as sp

    rows = np.concatenate([blk.obj_row, blk.a_row])
    cols = np.concatenate([blk.obj_col, blk.a_col])
    vals = np.concatenate([blk.obj_val, -y[blk.a_con] * blk.a_val])
    L = sp.coo_matrix((vals, (rows, cols)), shape=(blk.dim, blk.dim))
    L = L.tocsr()
    return (L + L.T - sp.diags(L.diagonal())).tocsr()


def _min_eig_sparse(S) -> float:
    """Smallest eigenvalue of a sparse symmetric matrix: dense eigh up
    to n = 2000, else ARPACK on the spectrum flipped about a Gershgorin
    bound (the largest eigenvalue of c I - S converges fastest)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla

    n = S.shape[0]
    if n <= 2000:
        return float(np.linalg.eigvalsh(S.toarray())[0])
    c = float(abs(S).sum(axis=1).max())
    top = sla.eigsh(c * sp.identity(n, format="csr") - S, k=1,
                    which="LA", tol=1e-10, ncv=64, maxiter=100000,
                    v0=np.random.default_rng(0).standard_normal(n),
                    return_eigenvectors=False)
    return c - float(top[0])


def verify_solution(problem, npz_path: str, check_dual: bool):
    """DIMACS-style errors of an exported solution, recomputed from
    X_i = F_i F_i^T, the LP values, the dual y and the problem data:
    pinf = ||b - A(X)||_2 / (1 + ||b||_1), gap = |pobj - dobj| /
    (1 + |pobj| + |dobj|) and, with ``check_dual``, dinf = (LP slack
    violation + sum_i |min(lambda_min(C_i - A_i^*(y)), 0)|) /
    (1 + ||C||_1) — the solver's own definitions."""
    m = problem.m
    with np.load(npz_path) as z:
        fs = [z[f"f{i}"] for i in range(problem.n_sdp_blocks)]
        x_lp = z["lp"] if "lp" in z.files else None
        y = z["y"]
    Ax = np.zeros(m)
    pobj = 0.0
    for blk, F in zip(problem.blocks, fs):
        Ax += np.bincount(blk.a_con, minlength=m, weights=_entry_terms(
            blk.a_row, blk.a_col, blk.a_val, F))
        pobj += float(np.sum(_entry_terms(blk.obj_row, blk.obj_col,
                                          blk.obj_val, F)))
    lp_part = 0.0
    if problem.lp is not None:
        lp = problem.lp
        Ax += np.bincount(lp.a_con, weights=lp.a_val * x_lp[lp.a_col],
                          minlength=m)
        pobj += float(lp.obj @ x_lp)
        red = lp.obj - np.bincount(lp.a_col, weights=lp.a_val * y[lp.a_con],
                                   minlength=lp.n_cols)
        lp_part = float(np.sum(np.abs(np.minimum(red, 0.0))))
    dobj = float(problem.rhs @ y)
    out = {
        "pobj": pobj, "dobj": dobj,
        "pinf": float(np.linalg.norm(problem.rhs - Ax)
                      / (1.0 + problem.rhs_nrm1())),
        "gap": abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj)),
    }
    if check_dual:
        neg = sum(abs(min(_min_eig_sparse(_slack_sparse(blk, y)), 0.0))
                  for blk in problem.blocks)
        out["dinf"] = (lp_part + neg) / (1.0 + problem.obj_nrm1())
    return out


def check_bands(name: str, errs: dict, tol: float = PHASE2_TOL) -> None:
    """The program's own acceptance bands for primal_dual_optimal."""
    bands = {"pinf": tol, "gap": 5 * tol, "dinf": 5 * tol}
    for key, band in bands.items():
        if key in errs and not errs[key] <= band:
            raise AssertionError(f"{name}: recomputed {key} "
                                 f"{errs[key]:.3e} > {band:.0e}")


# ---------------------------------------------------------------------------
# Phase 2: solves through the CLI entry point.
# ---------------------------------------------------------------------------

_REPORT = {
    "status": r"End Program with status `(\w+)`",
    "pobj": r"1\.Primal Objective:\s*:\s*(\S+)",
    "alm": r"ALM outer / inner iterations: (\d+) / (\d+), time \(s\): (\S+)",
    "admm": r"ADMM / CG iterations: (\d+) / (\d+), time \(s\): (\S+)",
    "dtype": r"final dtype: (\w+)",
}


def run_cli(argv):
    """lorads_tpu.__main__.main in this process; returns the parsed
    report and the wall time."""
    from lorads_tpu.__main__ import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"CLI exit {rc} for {argv}:\n{text[-3000:]}")
    rep = {"text": text}
    for key, pat in _REPORT.items():
        mt = re.search(pat, text)
        if mt is None:
            raise RuntimeError(f"no {key!r} in the CLI report for "
                               f"{argv}:\n{text[-3000:]}")
        rep[key] = mt.groups() if len(mt.groups()) > 1 else mt.group(1)
    return rep, wall


def peak_bytes() -> int:
    """Running peak of device 0's memory in this process (-1 where
    the backend keeps no statistics)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def solve_and_verify(name, path, problem, tmp, extra=(), check_dual=False,
                     runs=("cold", "warm"), expect_log=None):
    """Solve through the CLI (cold, then warm in the same process),
    require primal_dual_optimal and verify the exported solution.
    With ``expect_log`` the solver log is kept and must contain it."""
    sol = os.path.join(tmp, f"{name}.npz")
    argv = [path, "--phase2Tol", str(PHASE2_TOL), "--solOut", sol, *extra]
    if expect_log is None:
        argv.append("--quiet")
    walls = {}
    for run in runs:
        rep, walls[run] = run_cli(argv)
        if rep["status"] != "primal_dual_optimal":
            raise AssertionError(f"{name} ({run}): status {rep['status']}")
        if expect_log is not None:
            line = next((ln for ln in rep["text"].splitlines()
                         if expect_log in ln), None)
            if line is None:
                raise AssertionError(f"{name}: no {expect_log!r} in log")
            log(f"[phase2] {name}: {line.strip()}")
    errs = verify_solution(problem, sol, check_dual)
    check_bands(name, errs)
    outer, inner, t_alm = rep["alm"]
    admm, cg, t_admm = rep["admm"]
    inner, admm = int(inner), int(admm)
    log(f"[phase2] {name}: primal_dual_optimal; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + f"; dtype {rep['dtype']}; ALM outer {outer} inner {inner}; "
        f"ADMM {admm}; CG {cg}; peak device bytes {peak_bytes()}")
    log(f"[phase2] {name}: recomputed "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    log(f"[phase2] {name}: per-iteration wall (last run): ALM inner "
        f"{1e3 * float(t_alm) / max(inner, 1):.3f} ms "
        f"({inner} in {float(t_alm):.3f} s), ADMM "
        f"{1e3 * float(t_admm) / max(admm, 1):.3f} ms "
        f"({admm} in {float(t_admm):.3f} s)")
    return float(rep["pobj"])


def multiblock_problem():
    """Blocks of several sizes plus an LP block, all sharing one set of
    constraints (feasible and bounded: each part is, and b adds up)."""
    from lorads_tpu.core.problem import SDPProblem
    from lorads_tpu.io import generators

    parts = [generators.random_multiblock(**kw)
             for kw in SIZES["multiblock"]]
    lp = next((p.lp for p in parts if p.lp is not None), None)
    return SDPProblem(m=parts[0].m, rhs=sum(p.rhs for p in parts),
                      blocks=[b for p in parts for b in p.blocks], lp=lp)


def phase2(tmp):
    from lorads_tpu import native
    from lorads_tpu.io import generators
    from lorads_tpu.io.sdpa import read_sdpa, write_sdpa

    require_gpu()
    mc = generators.maxcut(**SIZES["phase2_maxcut"])
    mc_path = os.path.join(tmp, "maxcut.dat-s")
    write_sdpa(mc_path, mc)
    reader = "native C++" if native.load() is not None else "pure Python"
    log(f"[phase2] SDPA reader: {reader}")
    mc_read = read_sdpa(mc_path)

    big = generators.maxcut(**SIZES["phase2_maxcut_large"])
    big_path = os.path.join(tmp, "maxcut_large.dat-s")
    write_sdpa(big_path, big)
    mb = multiblock_problem()
    mb_path = os.path.join(tmp, "multiblock.dat-s")
    write_sdpa(mb_path, mb)
    theta_path = os.path.join(FIXTURES, "theta300.dat-s")
    matcomp_path = os.path.join(FIXTURES, "matcomp500.dat-s")

    n_mc = SIZES["phase2_maxcut"]["n"]
    solve_and_verify(f"maxcut{n_mc}", mc_path, mc_read, tmp,
                     check_dual=True)
    solve_and_verify(f"maxcut{n_mc} dtype=f64", mc_path, mc_read, tmp,
                     extra=("--dtype", "f64"), check_dual=True)
    solve_and_verify("theta300", theta_path, read_sdpa(theta_path), tmp,
                     check_dual=True)
    solve_and_verify("matcomp500", matcomp_path, read_sdpa(matcomp_path),
                     tmp)
    solve_and_verify("multiblock+lp", mb_path, read_sdpa(mb_path), tmp)
    solve_and_verify(f"maxcut{SIZES['phase2_maxcut_large']['n']}",
                     big_path, read_sdpa(big_path), tmp)


# ---------------------------------------------------------------------------
# --multi: sharded solves on four devices against one device.
# ---------------------------------------------------------------------------

def compare_sharded(tmp, mode, name, problem, n_devices=4,
                    check_dual=False):
    """Solve ``problem`` on one device and with ``--shard mode`` over
    ``n_devices``, both at f64, verify both and require their
    objectives to agree within 5 tol (relative).  At f32 a sharded and
    an unsharded solve sum in different orders and their trajectories
    part; theta800's certificate at tol 1e-5 then admits objectives
    1e-2 apart, so the comparison would test the tolerance, not the
    sharding."""
    from lorads_tpu.io.sdpa import read_sdpa, write_sdpa

    path = os.path.join(tmp, f"{mode}.dat-s")
    write_sdpa(path, problem)
    problem = read_sdpa(path)
    f64 = ("--dtype", "f64")
    p1 = solve_and_verify(f"{name} (1 device)", path, problem, tmp,
                          extra=f64, check_dual=check_dual)
    pn = solve_and_verify(f"{name} ({n_devices} devices)", path, problem,
                          tmp, extra=("--shard", mode, *f64),
                          check_dual=check_dual,
                          expect_log=f"{mode} buckets [0]")
    rel = abs(pn - p1) / max(abs(p1), 1.0)
    log(f"[multi] {name}: pobj 1 device {p1:.8e}, {n_devices} devices "
        f"{pn:.8e}, rel diff {rel:.2e}")
    if not rel <= 5 * PHASE2_TOL:
        raise AssertionError(f"{name}: sharded pobj differs by {rel:.2e}")


def phase_multi(tmp, n_devices: int = 4):
    from lorads_tpu.io import generators

    require_gpu(n_devices)
    compare_sharded(tmp, "dp", "multiblock dp",
                    generators.random_multiblock(**SIZES["multi_dp"]),
                    n_devices, check_dual=True)
    compare_sharded(tmp, "sp", f"maxcut{SIZES['multi_sp']['n']} sp",
                    generators.maxcut(**SIZES["multi_sp"]), n_devices)
    compare_sharded(tmp, "tp", f"theta{SIZES['multi_tp']['n']} tp",
                    generators.lovasz_theta(**SIZES["multi_tp"]),
                    n_devices, check_dual=True)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: run only the sharded dp/sp/tp solves "
                         "and their one-device comparisons")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "lorads_tpu")):
        raise RuntimeError(f"lorads_tpu package not found next to {__file__}")
    sys.path.insert(0, REPO)
    import jax

    import lorads_tpu  # noqa: F401  (x64, matmul precision, cache dir)

    n_dev = 4 if args.multi else 1
    devs = phase0(n_dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lorads_smoke_") as tmp:
        if args.multi:
            phase_multi(tmp, n_dev)
        else:
            phase1()
            log(f"[phase1] done at {time.perf_counter() - t0:.1f} s")
            phase2(tmp)
    log(f"[done] {time.perf_counter() - t0:.1f} s after phase 0")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
