"""Factor-row (tensor-parallel-style) sharding for very large dense cones.

The third sharding axis (after block-axis dp in sharded.py and
pattern-axis sp in pattern_sharded.py): the O(n^2) dense objects —
sym(UV^T) and W = C + A^*(w) — are sharded by ROW SLAB over the mesh,
i.e. the JAX equivalent of a row-distributed dsyr2k/dsymm
(reference dense kernels: lorads_alg_common.c:50-67 via fds_syr2k,
lorads_sdp_data.c:646-671 via dsymm).  Factors U, V (n x r, small)
stay replicated; device d owns rows [d*n_loc, (d+1)*n_loc) of every
n x n intermediate and exactly the constraint entries whose row index
falls in its slab.

Per gradient step the only cross-device traffic is:
  * psum of the per-constraint inner products        [m_loc]
  * all_gather of the disjoint W.U row slabs         [n_loc, r] each
— both are collectives across the devices.  The n x n matrices are
never materialized on one
device, so the memory ceiling for a single huge dense cone becomes
n^2/D per chip.

Entries are stored in FULL symmetric form (lower-tri entries + their
mirrors), which makes the inner-product weights and the W scatter the
same entry list: <A, X> = sum v * X[r, c] over full entries, and
W[r, c] += w * v scatters the exact symmetric W.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from lorads_tpu.core.presolve import BlockPlan
from lorads_tpu.ops import pattern as pat

AXIS = "rows"


def _full_sym_entries(plan: BlockPlan):
    """Constraint entries in FULL symmetric form (lower-tri + mirrors):
    <A, X> = sum v * X[r, c] over the full list, and W[r, c] += w * v
    scatters the exact symmetric W — one entry list serves both."""
    er = plan.pat_rows[plan.a_pos]
    ec = plan.pat_cols[plan.a_pos]
    off = er != ec
    rows = np.concatenate([er, ec[off]])
    cols = np.concatenate([ec, er[off]])
    vals = np.concatenate([plan.a_val, plan.a_val[off]])
    cons = np.concatenate([plan.a_con_loc, plan.a_con_loc[off]])
    return rows, cols, vals, cons


def build_rowshard_bucket(plan: BlockPlan, m_glob: int, n_devices: int,
                          dtype, mesh: Mesh = None) -> pat.BucketData:
    """Build the integrated row-slab (tp) bucket for one dense cone.

    Returns a BucketData with ``rowshard=True`` whose leading axis is
    the D mesh shards (see BucketData.rowshard for the data model).
    The solver shards it with P("blk") and every kernel — ALM gradient
    and line search, ADMM subproblem/CG, the Lanczos dual certificate —
    runs unchanged on the slab layout; this is the full-solve
    integration of the row-distributed dsyr2k/dsymm equivalents
    (reference lorads_dense_opts.c:529-539, lorads_sdp_data.c:646-671).
    """
    n, D = plan.dim, n_devices
    n_loc = -(-n // D)
    if n_loc * n >= 2 ** 31:
        raise ValueError(
            f"row-slab linear indices overflow int32 (n_loc*n = "
            f"{n_loc * n:.3g}); use more devices so n/D * n < 2^31")

    rows, cols, vals, cons = _full_sym_entries(plan)
    shard_of = rows // n_loc
    counts = np.bincount(shard_of, minlength=D)
    nnz_loc = max(int(counts.max()), 1)

    a_lin = np.zeros((D, nnz_loc), np.int32)
    # pad slot m_loc: keeps the per-shard con ids sorted (the
    # a_con_sorted promise + f64 bounds); segment_sum drops
    # out-of-range ids and gather_w clamps are zeroed by a_val = 0
    a_con = np.full((D, nnz_loc), plan.m_loc, np.int32)
    a_val = np.zeros((D, nnz_loc), np.float64)
    lin2_exact = True
    for d in range(D):
        sel = shard_of == d
        cnt = int(sel.sum())
        lin_d = ((rows[sel] - d * n_loc).astype(np.int64) * n
                 + cols[sel]).astype(np.int32)
        con_d = cons[sel].astype(np.int32)
        val_d = vals[sel]
        # primary order: by constraint slot (constr_vals segment sum)
        o = np.argsort(con_d, kind="stable")
        a_lin[d, :cnt] = lin_d[o]
        a_con[d, :cnt] = con_d[o]
        a_val[d, :cnt] = val_d[o]
        ids_nz = lin_d[val_d != 0.0]
        lin2_exact &= bool(np.unique(ids_nz).size == ids_nz.size)

    # secondary copy sorted by slab slot (build_w's sorted scatter)
    lp = np.argsort(a_lin, axis=1, kind="stable")
    ta = np.take_along_axis

    # full-symmetric C row slabs
    c_slab = np.zeros((D, n_loc, n))
    coff = plan.pat_rows != plan.pat_cols
    c_r = np.concatenate([plan.pat_rows, plan.pat_cols[coff]])
    c_c = np.concatenate([plan.pat_cols, plan.pat_rows[coff]])
    c_v = np.concatenate([plan.c_pat, plan.c_pat[coff]])
    np.add.at(c_slab, (c_r // n_loc, c_r % n_loc, c_c), c_v)

    f = lambda x: jnp.asarray(x, dtype=dtype)
    i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
    z1 = np.zeros((D, 1))
    zi = np.zeros((D, 1), dtype=np.int32)
    glob_idx = np.tile(plan.loc2glob, (D, 1)).astype(np.int32)
    return pat.BucketData(
        dense=True, rowshard=True, mesh=mesh, n=n, n_loc=n_loc,
        K=n_loc * n,
        nnz_a=nnz_loc, m_loc=plan.m_loc, B=D, m_glob=m_glob,
        a_con_loc=i32(a_con), a_val_inner=f(a_val),
        glob_idx=i32(glob_idx),
        pat_rows=i32(zi), pat_cols=i32(zi), c_pat=f(z1),
        c_pat_inner=f(z1), pat_offdiag=f(z1), a_pos=i32(zi),
        a_lin=i32(a_lin), a_lin_t=i32(zi), a_val=f(a_val),
        a_val_mirror=f(z1), c_full=f(c_slab),
        a_pos_s=i32(ta(a_lin, lp, 1)),
        a_con_loc_s=i32(ta(a_con, lp, 1)),
        a_val_s=f(ta(a_val, lp, 1)),
        row_perm=i32(zi), pat_rows_s=i32(zi), pat_cols_rp=i32(zi),
        a_con_sorted=True, a_pos_sorted=True,
        a_lin2_exact=lin2_exact,
        # built at all dtypes since round 5 (COMP_CUMSUM f32 path)
        bnd_a_con=pat._bounds_np(a_con, plan.m_loc),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RowShardData:
    """Static per-device row-slab data, leading axis D (the mesh axis)."""

    # -- static --
    D: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))       # true dim
    n_loc: int = dataclasses.field(metadata=dict(static=True))   # slab rows
    m_loc: int = dataclasses.field(metadata=dict(static=True))
    m_glob: int = dataclasses.field(metadata=dict(static=True))
    nnz_loc: int = dataclasses.field(metadata=dict(static=True))
    # -- arrays, leading axis D --
    row0: jnp.ndarray       # int32 [D]      first global row of the slab
    c_slab: jnp.ndarray     # f     [D, n_loc, n]  C rows (full symmetric)
    a_lin: jnp.ndarray      # int32 [D, nnz] local_row * n + col
    a_con: jnp.ndarray      # int32 [D, nnz] local constraint slot (pad->m_loc)
    a_val: jnp.ndarray      # f     [D, nnz] full-symmetric entry values
    loc2glob: jnp.ndarray   # int32 [D, m_loc] global constraint ids

    @property
    def n_pad(self) -> int:
        return self.D * self.n_loc


def build_row_shards(plan: BlockPlan, m_glob: int, n_devices: int,
                     dtype) -> RowShardData:
    """Partition one block's rows into n_devices contiguous slabs.

    Works for any BlockPlan (the union pattern is expanded to full
    symmetric entries); intended for dense-mode single large cones
    where the n x n intermediates dominate memory/compute.
    """
    n, D = plan.dim, n_devices
    n_loc = -(-n // D)
    if n_loc * n >= 2 ** 31:
        # a_lin = local_row * n + col is int32 on device (x64 is off
        # in f32 production mode); refuse rather than wrap silently
        raise ValueError(
            f"row-slab linear indices overflow int32 (n_loc*n = "
            f"{n_loc * n:.3g}); use more devices so n/D * n < 2^31")

    # full symmetric entry lists (entry rows decide the owning device)
    er = plan.pat_rows[plan.a_pos]
    ec = plan.pat_cols[plan.a_pos]
    off = er != ec
    rows = np.concatenate([er, ec[off]])
    cols = np.concatenate([ec, er[off]])
    vals = np.concatenate([plan.a_val, plan.a_val[off]])
    cons = np.concatenate([plan.a_con_loc, plan.a_con_loc[off]])

    shard_of = rows // n_loc
    counts = np.bincount(shard_of, minlength=D)
    nnz_loc = max(int(counts.max()), 1)

    a_lin = np.zeros((D, nnz_loc), np.int32)
    a_con = np.full((D, nnz_loc), plan.m_loc, np.int32)
    a_val = np.zeros((D, nnz_loc), np.float64)
    c_slab = np.zeros((D, n_loc, n), np.float64)
    # C on the slab (full symmetric)
    c_r = np.concatenate([plan.pat_rows, plan.pat_cols[plan.pat_rows
                                                       != plan.pat_cols]])
    c_c = np.concatenate([plan.pat_cols, plan.pat_rows[plan.pat_rows
                                                       != plan.pat_cols]])
    c_v = np.concatenate([plan.c_pat, plan.c_pat[plan.pat_rows
                                                 != plan.pat_cols]])
    np.add.at(c_slab, (c_r // n_loc, c_r % n_loc, c_c), c_v)

    for d in range(D):
        sel = shard_of == d
        cnt = int(sel.sum())
        a_lin[d, :cnt] = (rows[sel] - d * n_loc) * n + cols[sel]
        a_con[d, :cnt] = cons[sel]
        a_val[d, :cnt] = vals[sel]

    return RowShardData(
        D=D, n=n, n_loc=n_loc, m_loc=plan.m_loc, m_glob=m_glob,
        nnz_loc=nnz_loc,
        row0=jnp.asarray(np.arange(D, dtype=np.int32) * n_loc),
        c_slab=jnp.asarray(c_slab, dtype),
        a_lin=jnp.asarray(a_lin), a_con=jnp.asarray(a_con),
        a_val=jnp.asarray(a_val, dtype),
        loc2glob=jnp.asarray(np.tile(plan.loc2glob, (D, 1))),
    )


def _pad_rows(X: jnp.ndarray, n_pad: int) -> jnp.ndarray:
    return jnp.pad(X, ((0, n_pad - X.shape[0]), (0, 0)))


def uvt_slab(rs: RowShardData, row0, U: jnp.ndarray, V: jnp.ndarray,
             U_pad: jnp.ndarray, V_pad: jnp.ndarray) -> jnp.ndarray:
    """Row slab of sym(UV^T): 0.5 (U_loc V^T + V_loc U^T) -> [n_loc, n].

    The row-sharded dsyr2k: each device computes only its slab as a
    matrix product (reference: fds_syr2k, lorads_dense_opts.c:529-539).
    """
    r = U.shape[1]
    zero = jnp.zeros((), row0.dtype)
    U_loc = jax.lax.dynamic_slice(U_pad, (row0, zero), (rs.n_loc, r))
    V_loc = jax.lax.dynamic_slice(V_pad, (row0, zero), (rs.n_loc, r))
    hi = jax.lax.Precision.HIGHEST
    return 0.5 * (
        jnp.einsum("kr,nr->kn", U_loc, V, precision=hi,
                   preferred_element_type=U.dtype)
        + jnp.einsum("kr,nr->kn", V_loc, U, precision=hi,
                     preferred_element_type=U.dtype))


def slab_constr_vals(rs: RowShardData, slab: jnp.ndarray, a_lin, a_con,
                     a_val) -> jnp.ndarray:
    """Per-device partial <A_i, X> from the slab entries -> [m_loc]
    (psum over the mesh gives the cone totals)."""
    g = slab.reshape(-1)[a_lin] * a_val
    return jax.ops.segment_sum(g, a_con,
                               num_segments=rs.m_loc + 1)[: rs.m_loc]


def slab_build_w(rs: RowShardData, w_loc: jnp.ndarray, a_lin, a_con,
                 a_val, c_slab, include_obj: bool = True) -> jnp.ndarray:
    """W slab = [C +] sum_i w_i A_i restricted to the device's rows."""
    w1 = jnp.concatenate([w_loc, jnp.zeros((1,), w_loc.dtype)])
    contrib = w1[a_con] * a_val
    W = jax.ops.segment_sum(contrib, a_lin,
                            num_segments=rs.n_loc * rs.n)
    W = W.reshape(rs.n_loc, rs.n)
    return c_slab + W if include_obj else W


def make_row_sharded_gradient(mesh: Mesh, rs: RowShardData,
                              c_nrm_inf: float):
    """Row-sharded ALM gradient step for one large dense cone:

        total = A(sym(UU^T));  w = rho (total - b) - dual
        grad  = 2 (C + A^*(w)) U;   cert = ||grad|| / (1 + ||C||_inf)

    All n x n intermediates stay sharded by row slab; factors are
    replicated.  Returns (total [m_glob], grad [n, r], cert).
    """
    dspec = jax.tree.map(lambda _: P(AXIS), rs)

    @partial(shard_map, mesh=mesh,
             in_specs=(dspec, P(), P(), P(), P()),
             out_specs=(P(), P(), P()), check_vma=False)
    def step(rs_d, U, rhs_, dual_, rho_):
        row0 = rs_d.row0[0]
        a_lin, a_con = rs_d.a_lin[0], rs_d.a_con[0]
        a_val, c_slab = rs_d.a_val[0], rs_d.c_slab[0]
        U_pad = _pad_rows(U, rs.n_pad)
        slab = uvt_slab(rs, row0, U, U, U_pad, U_pad)
        vals = jax.lax.psum(
            slab_constr_vals(rs, slab, a_lin, a_con, a_val), AXIS)
        l2g = rs_d.loc2glob[0]
        total = jax.ops.segment_sum(
            vals, l2g, num_segments=rs.m_glob + 1)[: rs.m_glob]
        w = rho_ * (total - rhs_) - dual_
        W = slab_build_w(rs, w[l2g], a_lin, a_con, a_val, c_slab)
        # row-sharded dsymm: W_slab @ U -> disjoint grad rows
        g_loc = 2.0 * jnp.einsum(
            "kn,nr->kr", W, U, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=U.dtype)
        sq = jax.lax.psum(jnp.sum(g_loc * g_loc), AXIS)
        grad = jax.lax.all_gather(g_loc, AXIS, tiled=True)[: rs.n]
        cert = jnp.sqrt(sq) / (1.0 + c_nrm_inf)
        return total, grad, cert

    return step
