"""Pattern-axis (sequence-parallel-style) sharding for single large cones.

Block-axis sharding (sharded.py) gives nothing for problems with one
big PSD block — the flagship Max-Cut case.  Here the UNION PATTERN
itself is sharded: each device owns a contiguous range of pattern
slots plus exactly the constraint entries that scatter into that range
(entries are pre-sorted by slot, so the partition is clean), with the
factor matrices U/V replicated (n x r is small).

Per gradient/step the only cross-device traffic is:
  * psum of the per-constraint inner products  [m_loc]
  * psum of the partial W.X products           [n, r]
— both are collectives across the devices; everything else is
shard-local gather/segment-sum.

Shapes: every array gets a leading device axis D and is sharded on it
with shard_map; inside the mapped function each device sees its own
single-shard BucketData (B=1) and calls the ordinary ops/pattern.py
kernels unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from lorads_tpu.core.presolve import BlockPlan
from lorads_tpu.ops import pattern as pat

AXIS = "sp"


def build_pattern_shards(plan: BlockPlan, m_glob: int, n_devices: int,
                         dtype, summed: bool = False,
                         mesh=None) -> pat.BucketData:
    """Partition one block's union pattern into n_devices contiguous
    slot ranges and build a [D]-stacked BucketData (device axis
    leading, i.e. the usual B axis doubles as the shard axis).

    Entries are ordered by pattern slot so each entry lands on the
    device owning its slot; per-device entry counts are padded to the
    max.  Local a_pos indices are rebased to the shard's range.
    """
    K, nnz = plan.K, plan.nnz_a
    D = n_devices
    k_per = -(-K // D)
    K_pad = k_per * D

    # entries sorted by slot
    order = np.argsort(plan.a_pos, kind="stable")
    a_pos_s = plan.a_pos[order]
    a_con_s = plan.a_con_loc[order]
    a_val_s = plan.a_val[order]
    shard_of_entry = a_pos_s // k_per
    counts = np.bincount(shard_of_entry, minlength=D)
    nnz_loc = max(int(counts.max()), 1)

    pat_rows = np.zeros((D, k_per), np.int32)
    pat_cols = np.zeros((D, k_per), np.int32)
    c_pat = np.zeros((D, k_per))
    a_pos_l = np.zeros((D, nnz_loc), np.int32)
    a_con_l = np.zeros((D, nnz_loc), np.int32)
    a_val_l = np.zeros((D, nnz_loc))
    for d in range(D):
        lo, hi = d * k_per, min((d + 1) * k_per, K)
        w = hi - lo
        pat_rows[d, :w] = plan.pat_rows[lo:hi]
        pat_cols[d, :w] = plan.pat_cols[lo:hi]
        c_pat[d, :w] = plan.c_pat[lo:hi]
        sel = shard_of_entry == d
        cnt = int(sel.sum())
        a_pos_l[d, :cnt] = a_pos_s[sel] - lo
        a_con_l[d, :cnt] = a_con_s[sel]
        a_val_l[d, :cnt] = a_val_s[sel]
        # padding entries scatter zero value into slot 0

    # build via the standard constructor on a synthetic [D]-bucket plan
    from lorads_tpu.core.presolve import BucketPlan

    bp = BucketPlan(
        dense=False, plans=[plan] * D, n=plan.dim, K=k_per,
        nnz_a=nnz_loc, m_loc=plan.m_loc, rank=plan.rank,
        rank_max=plan.rank_max,
        dims=np.full(D, plan.dim, np.int32),
        pat_rows=pat_rows, pat_cols=pat_cols, c_pat=c_pat,
        a_pos=a_pos_l, a_con_loc=a_con_l, a_val=a_val_l,
        a_diag_w=np.where(
            np.take_along_axis(pat_rows, a_pos_l, 1)
            == np.take_along_axis(pat_cols, a_pos_l, 1), 1.0, 2.0),
        glob_idx=np.tile(plan.loc2glob, (D, 1)).astype(np.int32),
    )
    bk = pat.build_bucket_data(bp, m_glob, dtype, summed=summed)
    if mesh is not None:
        import dataclasses as _dc
        bk = _dc.replace(bk, mesh=mesh)
    if summed:
        # parent-cone diag-identity detection (constraint i == diagonal
        # entry i): per-shard diag_ident is False by construction, but
        # the aop diag-fast path still applies with a replicated full
        # diagonal map (see BucketData.diag_parent)
        n = plan.dim
        er = plan.pat_rows[plan.a_pos]
        ec = plan.pat_cols[plan.a_pos]
        is_d = er == ec
        ident = (plan.m_loc == n and plan.nnz_a == n
                 and bool(np.all(is_d))
                 and bool(np.all(np.sort(plan.a_con_loc) == np.arange(n)))
                 and bool(np.all(er[np.argsort(plan.a_con_loc,
                                               kind="stable")]
                                 == np.arange(n))))
        if ident:
            full = np.zeros(n)
            full[plan.a_con_loc] = plan.a_val
            import dataclasses as _dc
            bk = _dc.replace(
                bk, diag_parent=True,
                a_val_d_full=jnp.asarray(np.tile(full, (D, 1)), dtype))
    return bk


def make_sharded_gradient(mesh: Mesh, bk: pat.BucketData, rhs,
                          c_nrm_inf: float):
    """Sharded ALM gradient: grad = 2 (C + A^*(w)) U with the pattern
    sharded over the mesh; w = rho (A(UU^T) - b) - dual."""
    bspec = jax.tree.map(lambda _: P(AXIS), bk)

    @partial(shard_map, mesh=mesh,
             in_specs=(bspec, P(), P(), P(), P()),
             out_specs=(P(), P(), P()), check_vma=False)
    def step(bk_d, U, rhs_, dual_, rho_):
        uvt_val = pat.uvt(bk_d, U[None], U[None])
        vals = jax.lax.psum(
            pat.constr_vals(bk_d, uvt_val)[0], AXIS)       # [m_loc]
        total = pat.scatter_constr(bk_d, vals[None])        # [m]
        w = rho_ * (total - rhs_) - dual_
        w_loc = pat.gather_w(bk_d, w)
        W = pat.build_w(bk_d, w_loc)
        grad = 2.0 * jax.lax.psum(
            pat.w_mul(bk_d, W, U[None])[0], AXIS)          # [n, r]
        cert = jnp.sqrt(jnp.sum(grad * grad)) / (1.0 + c_nrm_inf)
        return total, grad, cert

    return step
