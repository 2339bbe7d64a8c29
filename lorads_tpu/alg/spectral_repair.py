"""Spectral-bundle dual repair (VERDICT r2 #2; extension, no
reference counterpart): shift the dual along the least-squares
preimage of the slack's offending eigendirections.

Complementarity refinement (dualrefine.py) is blind to a negative
slack direction v orthogonal to range(R) — at near-optimum range(X)
spans null(S), so the binding direction is EXACTLY the one
||S R||_F cannot see (measured on theta n=300: CGNR left dinf at
7.5e-4).  This repair works on the spectrum directly.  Per round:

* certificate pass -> per-block min eigenpair (lam, v) of
  S = C - A^*(lambda);
* for each failing block, one rank-1 kernel dispatch gives
  c_v = <C, vv^T> and g = A(vv^T), so the Rayleigh quotient at ANY
  dual is the affine function c_v - g . lambda — every collected
  direction joins a persistent bundle that is re-evaluated on host
  for free;
* a min-norm dual step with b^T dlam = 0 (dObj/gap exactly
  preserved) moves every bundled Rayleigh quotient to a small
  positive target (0.25 |lam| overshoot: Ritz values under-estimate
  |lam_min|), solved as a tiny k x k least-squares system.

Rounds stop when the re-measured dinf passes its band, fails to
improve, or the round budget is spent; the best certified dual is
kept only if it passes.  The level-2 reopt grind
(lorads_solver.c:1075-1117) remains the fallback.  No-LP problems
only (a dual move changes LP column slacks).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lorads_tpu.ops import pattern as pat


@jax.jit
def _proj_slack(bk, dual, Bmat):
    """Projected slack P = B^T (C - A^*(dual)) B per block, computed
    ON DEVICE: Bmat [b_eff, n, p] holds each block's (zero-padded)
    direction basis, output [b_eff, p, p].  One small-output dispatch
    replaces shipping the full affine coefficient tensor
    (P_CAP^2 x m doubles) to host every repair round."""
    w_loc = pat.gather_w(bk, -dual)
    W = pat.build_w(bk, w_loc)
    SB = pat.w_mul(bk, W, Bmat)
    return jnp.einsum("bnp,bnq->bpq", Bmat, SB,
                      precision=jax.lax.Precision.HIGHEST)


@jax.jit
def _cross_pieces(bk, Vi, Vj):
    """(<C, sym(v w^T)> [q], A(sym(v w^T)) [q, m]) for batched vector
    pairs Vi, Vj [q, B, n, 1], each holding one direction in one
    block's slab (zeros elsewhere).  ONE dispatch per repair round
    per bucket: these are the affine coefficients of the PROJECTED
    slack matrix P(lambda)_ij = <sym(v_i v_j^T), C - A^*(lambda)>, so
    the spectral repair's inner loop re-evaluates P for free on host."""
    def one(a, c):
        uv = pat.uvt(bk, a, c)
        return (jnp.sum(pat.obj_inner(bk, uv)),
                pat.scatter_constr(bk, pat.constr_vals(bk, uv)))
    return jax.vmap(one)(Vi, Vj)


def _prox_solve(M, reg, t):
    """alpha = (M + reg I)^{-1} t at the ambient dtype.  The system is
    divided by its largest entry first: M is a Gram matrix whose scale
    follows rho and the objective, and the normalization keeps the LU
    pivots O(1)."""
    Mn = M + reg * jnp.eye(M.shape[0], dtype=M.dtype)
    sc = jnp.maximum(jnp.max(jnp.abs(Mn)), 1e-30)
    return jnp.linalg.solve(Mn / sc, t / sc)


@partial(jax.jit, static_argnames=("n_iters", "con_pad"))
def _active_set_device(bk, Bmat, p_mask, dual0, rhs, delta, sigma,
                       n_iters=12, con_pad=12):
    """One repair round's ACTIVE-SET loop as a single device program
    (round 4; VERDICT r3 #5).  The host version dispatched 2 kernels +
    a host eigh + several transfers per inner iteration, and on
    theta300 that per-iteration latency was most of the steady solve.

    Single-bucket form (the eigh-rescue/theta case).  Per iteration,
    entirely on device:
      P = B^T (C - A^*(dual0 + d)) B per block, masked to each
      block's real basis width; batched eigh; the con_pad lowest
      eigenpairs ACROSS the bucket's blocks become candidate
      directions (evals < delta); their affine pieces
      c_u = <C, uu^T>, g_u = A(uu^T) append to a fixed-width
      constraint buffer; a b-orthogonal proximally-regularized
      least-squares step moves every active Rayleigh quotient to
      delta.  Stops early when no eigenvalue sits below delta.

    Returns one packed f64 vector [d_tot (m) | n_cons | n_iter_used]
    so the host fetch is a single leaf.
    """
    b_eff, n, P = Bmat.shape
    m = rhs.shape[0]
    dt = Bmat.dtype
    R_rows = n_iters * con_pad
    # padded eigh dims must sit safely ABOVE the activation threshold
    # delta (which scales with c_nrm1 via norm) or they become
    # zero-gradient phantom directions that suppress the none_new
    # early exit (ADVICE r4): anchor the pad diagonal to delta itself
    BIG = delta + jnp.abs(delta) + 1.0
    bb = jnp.vdot(rhs, rhs)
    m2 = p_mask[:, :, None] * p_mask[:, None, :]          # [b_eff,P,P]
    eyeP = jnp.eye(P, dtype=dt)[None]
    onehot_rows = jnp.arange(b_eff)

    def pieces(Vq):
        # affine pieces of sym(u u^T) for one padded direction slab
        uv = pat.uvt(bk, Vq, Vq)
        return (jnp.sum(pat.obj_inner(bk, uv)),
                pat.scatter_constr(bk, pat.constr_vals(bk, uv)))

    def body(c):
        d_tot, G, cs, rv, it, _ = c
        dual_cur = dual0 + d_tot
        # projected slack, masked to real basis widths
        w_loc = pat.gather_w(bk, -dual_cur)
        W = pat.build_w(bk, w_loc)
        SB = pat.w_mul(bk, W, Bmat)
        Pm = jnp.einsum("bnp,bnq->bpq", Bmat, SB,
                        precision=jax.lax.Precision.HIGHEST)
        Pm = 0.5 * (Pm + jnp.swapaxes(Pm, 1, 2))
        Pm = Pm * m2 + BIG * (1.0 - m2) * eyeP
        evals, Wv = jnp.linalg.eigh(Pm)                    # ascending
        flat = evals.reshape(-1)                           # [b_eff*P]
        _, idx = jax.lax.top_k(-flat, con_pad)             # lowest k
        ev_sel = flat[idx]
        bi, ci = idx // P, idx % P
        valid = (ev_sel < delta * (1 - 1e-9)).astype(dt)   # [con_pad]
        # u = B[bi] @ Wv[bi,:,ci], one per direction
        u_q = jax.vmap(lambda b, c_: Bmat[b] @ Wv[b, :, c_])(bi, ci)
        slab = (onehot_rows[None, :] == bi[:, None]).astype(dt)
        Vq = u_q[:, None, :, None] * slab[:, :, None, None]
        cu, gu = jax.vmap(pieces)(Vq)                      # [k], [k,m]
        gu = gu * valid[:, None]
        # invalid rows: g = 0 and cs = delta makes their target t = 0
        cs_q = jnp.where(valid > 0, cu, delta)
        row0 = it * con_pad
        zero = jnp.zeros((), jnp.int32)
        G = jax.lax.dynamic_update_slice(G, gu, (row0, zero))
        cs = jax.lax.dynamic_update_slice(cs, cs_q, (row0,))
        rv = jax.lax.dynamic_update_slice(rv, valid, (row0,))
        # b-orthogonal, proximally regularized LS step on the FULL
        # buffer (inactive rows are zero; they get alpha = 0)
        Gp = jnp.where(bb > 0,
                       G - (G @ rhs / jnp.maximum(bb, 1e-300))[:, None]
                       * rhs[None], G)
        rq = cs - G @ dual_cur
        t = rq - jnp.maximum(rq, delta)
        M = Gp @ Gp.T
        nval = jnp.maximum(jnp.sum(rv), 1.0)
        reg = sigma * jnp.maximum(jnp.trace(M) / nval, 1e-30)
        alpha = _prox_solve(M, reg, t)
        # no new directions -> the host loop breaks WITHOUT a step;
        # gate the update the same way (the done flag exits next)
        none_new = jnp.sum(valid) == 0
        d_tot = jnp.where(none_new, d_tot, d_tot + Gp.T @ alpha)
        return (d_tot, G, cs, rv, it + 1, none_new)

    def cond(c):
        return (c[4] < n_iters) & (~c[5])

    init = (jnp.zeros((m,), dt), jnp.zeros((R_rows, m), dt),
            jnp.zeros((R_rows,), dt), jnp.zeros((R_rows,), dt),
            jnp.zeros((), jnp.int32), jnp.asarray(False))
    d_tot, _, _, rv, it, _ = jax.lax.while_loop(cond, body, init)
    return jnp.concatenate([
        d_tot.astype(jnp.float64),
        jnp.stack([jnp.sum(rv), it.astype(dt)]).astype(jnp.float64)])


def try_spectral_repair(solver, admm_stats) -> bool:
    """Run the repair on ``solver`` (a LoradsSolver); returns True iff
    the repaired dual passes its dinf band (admm_stats updated)."""
    params = solver.params
    band = (params.phase2_tol if params.high_acc_mode
            else 5 * params.phase2_tol)
    t0 = time.time()
    old_dual = solver.dual
    norm = solver.scale_obj_his * (solver.pd.c_nrm1 + 1.0)
    b = np.asarray(solver.pd.rhs, np.float64)
    bb = float(b @ b)
    best_dinf, best_dual = admm_stats.dinf_l1, None
    floor = 1e-14 * max(1.0, float(solver.pd.c_nrm_inf))
    prev_dinf, since_impr = np.inf, 0
    traj = []
    bases = {}        # (bucket j, block bi) -> orthonormal [n, p]
    P_CAP = 48        # basis columns kept per block (theta n=300's
                      # binding subspace overflows a 24-cap: the
                      # oldest-first trim dropped directions that
                      # then re-sank, oscillating at 2-3e-4)
    delta = 0.5 * band * norm
    n_cons = 0
    # proximal control: the subspace model is exact, but a large
    # ||dlam|| damages the slack OUTSIDE the span (by ~||A^*(d)||);
    # sigma regularizes the constraint solve, backing off when a
    # round's measured dinf regresses (with the dual restored) and
    # relaxing when it improves
    sigma = 1e-2
    last_dinf, last_dual = np.inf, None
    for rnd in range(30):
        # measure at the CURRENT dual; collect offending eigenpairs
        # (the eigh-rescue certificate hands back up to _EIG_K
        # smallest pairs per block; Lanczos blocks one Ritz vector)
        lp_part, lams = solver._dual_infeas_pass()
        dinf = lp_part
        for lam in lams:
            dinf += float(np.sum(np.abs(np.minimum(lam, 0.0))))
        dinf /= norm
        traj.append(dinf)
        if dinf < best_dinf:
            best_dinf, best_dual = dinf, solver.dual
        # keep refining to 0.7*band when rounds are cheap so the
        # REPORTED dinf sits well inside the acceptance band
        # (acceptance itself stays <= band); VERDICT r4 #6 — the
        # round-4 0.9*band exit left theta300 at 90% of the budget,
        # one unlucky certificate draw from failure
        if dinf <= 0.7 * band:
            break
        restored = False
        if dinf > last_dinf * 1.02 and last_dual is not None:
            # regression: restore and retry with a heavier proximal
            # weight (the step was too aggressive for the off-span
            # spectrum)
            solver.dual = last_dual
            sigma *= 8.0
            restored = True
            if sigma > 1e5:
                break
        else:
            last_dinf, last_dual = dinf, solver.dual
            sigma = max(sigma * 0.9, 1e-4)
        # plateau exit: five non-backtracked rounds without improving
        # the BEST certified dinf by 10% means the subspace has
        # saturated without covering the violation — concede to the
        # reopt fallback rather than burn certificates (restored
        # rounds retry, they don't count)
        if not restored:
            since_impr = (0 if dinf < 0.9 * prev_dinf
                          else since_impr + 1)
            prev_dinf = min(prev_dinf, dinf)
        if since_impr >= 5:
            break
        # grow each block's basis with the newly measured
        # eigendirections (orthonormalized; the measured vectors are
        # genuine slack eigenvectors, so new components only appear
        # when the violation lives outside today's span)
        grab = 2.0 * band * norm
        for j in range(len(solver.pd.buckets)):
            vec = np.asarray(jax.device_get(solver.last_cert_vecs[j]),
                             np.float64)
            lk = np.asarray(jax.device_get(solver.last_cert_lams_k[j]))
            for bi, ki in zip(*np.nonzero(lk < max(grab, floor))):
                Bb = bases.get((j, bi))
                v = vec[bi, ki].copy()
                if Bb is not None:
                    v -= Bb @ (Bb.T @ v)
                nv = np.linalg.norm(v)
                if nv < 1e-6:
                    continue
                bases[(j, bi)] = (
                    (v / nv)[:, None] if Bb is None
                    else np.concatenate([Bb, (v / nv)[:, None]], 1))
        if not bases:
            break
        # Per bucket, build the (zero-padded) device basis tensor and
        # evaluate the PROJECTED slack P = B^T S(lam) B on device
        # ([b_eff, p, p] output only).  Pinning sampled Rayleigh
        # quotients alone measurably stalls at ~1.5x band: once the
        # binding eigenvector rotates WITHIN the sampled span, it
        # rides off-diagonal couplings invisible to diagonal RQ
        # constraints.  The projected matrix sees them, and its
        # eigen-directions give exact affine constraints below.
        for key in list(bases):
            if bases[key].shape[1] > P_CAP:
                # oldest-first trim to the fixed device width
                bases[key] = bases[key][:, -P_CAP:]
        Bmats, p_real = {}, {}
        for j, bk in enumerate(solver.pd.buckets):
            blocks = [bi for (jj, bi) in bases if jj == j]
            if not blocks:
                continue
            b_eff = np.asarray(
                jax.device_get(solver.last_cert_vecs[j])).shape[0]
            Bm = np.zeros((b_eff, bk.n, P_CAP))
            for bi in blocks:
                Bb = bases[(j, bi)]
                Bm[bi, :, : Bb.shape[1]] = Bb
                p_real[(j, bi)] = Bb.shape[1]
            Bmats[j] = jnp.asarray(Bm, solver.dtype)
        # consume every eigenpair the eigh rescue returns per block
        # (_EIG_K = 12; VERDICT r4 #6)
        CON_PAD = 12
        if len(Bmats) == 1:
            # Fused path (round 4): the whole active-set loop runs as
            # ONE device program — the host version below pays
            # per-iteration dispatch + transfer latency.  Semantics
            # match the host loop
            # (same projected-slack model, same b-orthogonal
            # regularized step); the only deltas are the per-BUCKET
            # direction cap applied across blocks via top_k and the
            # masked-eigh padding.
            j = next(iter(Bmats))
            bk = solver.pd.buckets[j]
            Bm = Bmats[j]
            pm = np.zeros(Bm.shape[:1] + (P_CAP,))
            for (jj, bi), pw in p_real.items():
                if jj == j:
                    pm[bi, :pw] = 1.0
            out = jax.device_get(_active_set_device(
                bk, Bm, jnp.asarray(pm, solver.dtype), solver.dual,
                jnp.asarray(b, solver.dtype),
                jnp.asarray(delta, solver.dtype),
                jnp.asarray(sigma, solver.dtype)))
            d_tot = out[:-2]
            n_cons = int(out[-2])
            solver.dual = solver.dual + jnp.asarray(d_tot, solver.dtype)
            continue
        # host active-set loop (multi-bucket fallback): P's
        # eigen-directions (host eigh of [p, p]) give constraints
        # whose affine pieces c_u, g_u come from one SMALL padded
        # rank-1 dispatch per iteration; P itself is re-evaluated on
        # device at the moved dual (small dispatches, [p, p]
        # transfers)
        lam_h = np.asarray(solver.dual, np.float64)
        d_tot = np.zeros(solver.pd.m)
        cons_c, cons_g = [], []
        for _ in range(12):
            dual_cur = jnp.asarray(lam_h + d_tot, solver.dtype)
            new_dirs = []          # (j, bi, u)
            for j, Bm in Bmats.items():
                P_all = np.asarray(jax.device_get(_proj_slack(
                    solver.pd.buckets[j], dual_cur, Bm)), np.float64)
                for (jj, bi), pw in p_real.items():
                    if jj != j:
                        continue
                    P = P_all[bi][:pw, :pw]
                    P = 0.5 * (P + P.T)
                    evals, W = np.linalg.eigh(P)
                    for ei in np.nonzero(
                            evals < delta * (1 - 1e-9))[0][:CON_PAD]:
                        new_dirs.append(
                            (j, bi, bases[(j, bi)] @ W[:pw, ei]))
            if not new_dirs:
                break               # lam_min(P) >= delta everywhere
            # affine pieces of the new constraint directions
            for j in {d[0] for d in new_dirs}:
                bk = solver.pd.buckets[j]
                b_eff = Bmats[j].shape[0]
                dirs_j = [d for d in new_dirs if d[0] == j]
                Vk = np.zeros((CON_PAD, b_eff, bk.n, 1))
                for idx, (_, bi, u) in enumerate(dirs_j[:CON_PAD]):
                    Vk[idx, bi, :, 0] = u
                Vkd = jnp.asarray(Vk, solver.dtype)
                cu, gu = _cross_pieces(bk, Vkd, Vkd)
                cu = np.asarray(jax.device_get(cu), np.float64)
                gu = np.asarray(jax.device_get(gu), np.float64)
                for idx in range(min(len(dirs_j), CON_PAD)):
                    cons_c.append(cu[idx])
                    cons_g.append(gu[idx])
            G = np.stack(cons_g)
            cs = np.asarray(cons_c)
            Gp = G - (G @ b / max(bb, 1e-300))[:, None] * b[None] \
                if bb > 0 else G
            rq = cs - G @ (lam_h + d_tot)
            t = rq - np.maximum(rq, delta)
            M = Gp @ Gp.T
            reg = sigma * max(np.trace(M) / max(len(M), 1), 1e-30)
            alpha = np.linalg.solve(M + reg * np.eye(len(M)), t)
            d_tot = d_tot + Gp.T @ alpha
        n_cons = len(cons_g)
        solver.dual = solver.dual + jnp.asarray(d_tot, solver.dtype)
    accept = best_dinf <= band and best_dual is not None
    improved = best_dual is not None \
        and best_dinf < admm_stats.dinf_l1
    solver.log(f"spectral dual repair: dinf {admm_stats.dinf_l1:.2e}"
               f" -> {best_dinf:.2e} in {rnd + 1} rounds "
               f"({' '.join(f'{d:.1e}' for d in traj)}), basis "
               f"{sum(B.shape[1] for B in bases.values())} cons "
               f"{n_cons} [{time.time() - t0:.2f}s] -> "
               + ("accepted" if accept else
                  "kept (band unmet; reopt continues from here)"
                  if improved else "rejected"))
    if accept or improved:
        # b-orthogonal moves leave dObj/gap untouched, so a strictly
        # better certified dinf is kept even when the band is unmet —
        # the fallback reopt then starts closer
        solver.dual = best_dual
        dobj_new = float(jnp.vdot(solver.pd.rhs, solver.dual))
        dobj_new /= solver.scale_obj_his
        solver.dobj = dobj_new
        solver.gap = abs(solver.pobj - dobj_new) / (
            1.0 + abs(solver.pobj) + abs(dobj_new))
        admm_stats.dobj = dobj_new
        admm_stats.gap = solver.gap
        admm_stats.dinf_l1 = best_dinf
        admm_stats.dinf_inf = best_dinf * (1 + solver.pd.c_nrm1) / (
            1 + solver.pd.c_nrm_inf)
        return accept
    solver.dual = old_dual
    return False
