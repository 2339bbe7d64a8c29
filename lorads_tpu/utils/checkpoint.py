"""Checkpoint / resume for solver state.

The reference has no checkpointing (SURVEY.md §5); the closest
artifact is warm-started reopt from the in-memory (U, V, R, lambda,
rho) tuple (lorads_solver.c:1075-1117).  Here the factor/dual state is
a small pytree, saved per outer iteration as a single .npz plus a JSON
sidecar of host-side schedule state, so a long solve can resume after
preemption — the equivalent of a training-job checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from lorads_tpu.alg.state import FactorVec

_FORMAT_VERSION = 1


def _pack_fv(prefix: str, fv: FactorVec, out: dict):
    for i, x in enumerate(fv.cones):
        out[f"{prefix}_cone{i}"] = np.asarray(x)
    out[f"{prefix}_lp"] = np.asarray(fv.lp)


def _unpack_fv(prefix: str, data, n_cones: int, dtype) -> FactorVec:
    cones = tuple(jnp.asarray(data[f"{prefix}_cone{i}"], dtype=dtype)
                  for i in range(n_cones))
    return FactorVec(cones, jnp.asarray(data[f"{prefix}_lp"], dtype=dtype))


def save_checkpoint(path: str, solver, alm_stats=None, admm_stats=None,
                    phase: str = "alm") -> None:
    """Write solver state to `path` (.npz) + `path`.meta.json."""
    arrays: dict = {}
    _pack_fv("R", solver.R, arrays)
    _pack_fv("U", solver.U, arrays)
    _pack_fv("V", solver.V, arrays)
    _pack_fv("S", solver.S, arrays)
    arrays["dual"] = np.asarray(solver.dual)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)

    meta = dict(
        version=_FORMAT_VERSION,
        phase=phase,
        n_cones=len(solver.R.cones),
        ranks=list(solver.ranks),
        scale_obj_his=solver.scale_obj_his,
        rho_max=solver.rho_max,
        max_alm_sub_iter=solver.max_alm_sub_iter,
        pobj=solver.pobj, dobj=solver.dobj,
        gap=solver.gap, pinf_l1=solver.pinf_l1,
    )
    if alm_stats is not None:
        meta["alm"] = dataclasses.asdict(alm_stats)
    if admm_stats is not None:
        meta["admm"] = dataclasses.asdict(admm_stats)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, solver) -> dict:
    """Restore state saved by :func:`save_checkpoint` into `solver`.

    Returns the metadata dict (phase, stats) for the caller to resume
    schedules from.  Rank mismatches are handled by padding/truncation
    being the caller's job — ranks must match (the checkpoint stores
    them for verification).
    """
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} != "
                         f"{_FORMAT_VERSION}")
    data = np.load(path)
    n_cones = meta["n_cones"]
    if meta["ranks"] != list(solver.ranks):
        # grow/shrink solver buffers to the checkpointed ranks
        solver.ranks = list(meta["ranks"])
    solver.R = _unpack_fv("R", data, n_cones, solver.dtype)
    solver.U = _unpack_fv("U", data, n_cones, solver.dtype)
    solver.V = _unpack_fv("V", data, n_cones, solver.dtype)
    if "S_lp" in data:
        solver.S = _unpack_fv("S", data, n_cones, solver.dtype)
    solver.dual = jnp.asarray(data["dual"], dtype=solver.dtype)
    solver.scale_obj_his = meta["scale_obj_his"]
    solver.rho_max = meta["rho_max"]
    solver.max_alm_sub_iter = meta["max_alm_sub_iter"]
    solver.pobj = meta["pobj"]
    solver.dobj = meta["dobj"]
    solver.gap = meta["gap"]
    solver.pinf_l1 = meta["pinf_l1"]
    # objective data must be re-scaled to match the checkpoint; the
    # rebuild replaces any sharded placement, so re-shard afterwards
    # (mirrors maybe_escalate_f64)
    from lorads_tpu.alg import aop
    from lorads_tpu.alg.state import make_history
    if solver.scale_obj_his != 1.0:
        solver.pd = aop.build_problem_data(solver.ps, solver.dtype)
        solver.pd = aop.scale_objective(solver.pd, solver.scale_obj_his)
        if solver.mesh is not None:
            solver._maybe_shard()
    solver.hist = make_history(solver.R, solver.lbfgs_len)
    return meta
