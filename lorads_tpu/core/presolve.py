"""Presolve: static layout decisions + padded array construction.

This replaces the reference's runtime pointer-vtable dispatch with
trace-time static choices:

* cone sparsity (how many constraints touch a block) — reference
  `LUserDataChooseCone` (/root/reference/src_semi/io/lorads_user_data.c:58-83):
  a block is a "sparse cone" if its #nonzero constraint matrices
  <= 0.3 * m.  Here every block stores the compact (m_loc) constraint
  slot list plus a global index map, which subsumes both cases.
* union-pattern layout — reference `AConePresolveData`
  (/root/reference/src_semi/data/lorads_sdp_conic.c:868-1076): the
  per-block aggregate buffers (w_sum / obj_sum / slack) are DENSE if
  dim < 20, or any coefficient matrix is dense (per-matrix density >
  0.1, lorads_sdp_data.c:811-828), or the union density >= 0.1;
  otherwise SPARSE on the union pattern of all {C, A_i} nonzeros.
* the rank policy — reference `LORADSDetermineRank`
  (/root/reference/src_semi/data/lorads_solver.c:290-319).

Blocks are then grouped into shape buckets (geometric dim classes) so
same-shaped blocks can be vmapped / sharded on device; all ragged arrays
are zero-padded to per-bucket maxima.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from lorads_tpu.config import LoradsParams
from lorads_tpu.core.problem import SDPBlockData, SDPProblem


@dataclasses.dataclass
class BlockPlan:
    """Host-side static layout for one SDP block."""

    index: int               # original block index in the problem
    dim: int
    rank: int
    rank_max: int
    dense: bool              # union-pattern dense mode
    m_loc: int               # number of constraints touching this block
    loc2glob: np.ndarray     # int32 [m_loc]
    # union pattern, lower-tri (row >= col), sorted by (col,row)
    pat_rows: np.ndarray     # int32 [K]
    pat_cols: np.ndarray     # int32 [K]
    c_pat: np.ndarray        # float64 [K] — C entries on the pattern
    # constraint COO (flattened over constraints)
    a_con_loc: np.ndarray    # int32 [nnzA] — local constraint slot
    a_pos: np.ndarray        # int32 [nnzA] — index into the union pattern
    a_val: np.ndarray        # float64 [nnzA] — raw entry values

    @property
    def K(self) -> int:
        return int(self.pat_rows.size)

    @property
    def nnz_a(self) -> int:
        return int(self.a_val.size)


def plan_block(idx: int, blk: SDPBlockData, params: LoradsParams,
               n_cones: int) -> BlockPlan:
    n = blk.dim
    tri = n * (n + 1) // 2

    # --- union pattern over {C, A_i} (lorads_sdp_conic.c:965-988) ---
    all_rows = np.concatenate([blk.obj_row, blk.a_row])
    all_cols = np.concatenate([blk.obj_col, blk.a_col])
    key = all_rows.astype(np.int64) * n + all_cols
    uniq_key = np.unique(key)
    K = uniq_key.size
    union_density = K / tri if tri else 1.0

    # per-matrix dense detection (density > 0.1, lorads_sdp_data.c:811-828)
    pm_thr = params.per_matrix_dense_threshold
    any_dense = blk.nnz_obj > pm_thr * tri
    if not any_dense and blk.nnz_constr:
        counts = np.bincount(blk.a_con, minlength=blk.m)
        any_dense = counts.max() > pm_thr * tri

    dense = (
        n < params.dense_dim_threshold
        or any_dense
        or union_density >= params.dense_threshold
    )
    if dense:
        # dense mode: pattern = full packed lower triangle
        cols_grid, rows_grid = np.meshgrid(np.arange(n), np.arange(n),
                                           indexing="xy")
        mask = rows_grid >= cols_grid
        pat_rows = rows_grid.T[mask.T].astype(np.int32)
        pat_cols = cols_grid.T[mask.T].astype(np.int32)
        uniq_key = (pat_rows.astype(np.int64) * n + pat_cols)
        # sorted by (col, row): mask.T iteration is column-major already
        order = np.argsort(pat_cols * n + pat_rows, kind="stable")
        pat_rows, pat_cols = pat_rows[order], pat_cols[order]
        uniq_key = uniq_key[order]
        K = pat_rows.size
    else:
        pat_rows = (uniq_key // n).astype(np.int32)
        pat_cols = (uniq_key % n).astype(np.int32)

    # map (row,col) key -> pattern slot.  Dense mode stores the packed
    # lower triangle sorted by (col,row); sparse mode keeps np.unique's
    # sorted keys — both support vectorized searchsorted lookups.
    if dense:
        key_order = np.argsort(uniq_key, kind="stable")
        sorted_keys = uniq_key[key_order]

        def pos_lookup(keys):
            return key_order[np.searchsorted(sorted_keys, keys)] \
                .astype(np.int32)
    else:
        def pos_lookup(keys):
            return np.searchsorted(uniq_key, keys).astype(np.int32)

    c_pat = np.zeros(K, dtype=np.float64)
    if blk.obj_row.size:
        obj_keys = blk.obj_row.astype(np.int64) * n + blk.obj_col
        np.add.at(c_pat, pos_lookup(obj_keys), blk.obj_val)

    # --- compact constraint slots (lorads_sdp_conic.c:191-223) ---
    loc2glob = np.unique(blk.a_con).astype(np.int32)
    m_loc = loc2glob.size
    a_con_loc = np.searchsorted(loc2glob, blk.a_con).astype(np.int32)
    a_keys = blk.a_row.astype(np.int64) * n + blk.a_col
    a_pos = pos_lookup(a_keys) if a_keys.size else np.zeros(0, np.int32)

    # --- rank policy (lorads_solver.c:290-319) ---
    nnz_rows = m_loc
    sqrt_cap = int(math.sqrt(2 * nnz_rows)) + 1 if nnz_rows else 1
    rank_max = min(sqrt_cap, n)
    t = params.times_log_rank
    if t is None:
        # structure-based auto (see LoradsParams.times_log_rank)
        t = 2.0 if n <= 32768 else 3.0
    if t <= 1e-6:
        rank = min(sqrt_cap, n)
    elif nnz_rows / n >= 20 and n <= 400 and n_cones <= 3:
        rank = min(sqrt_cap, n)
    else:
        rank = min(int(math.ceil(t * math.log(max(n, 2)))), sqrt_cap, n)
    rank = max(1, rank)

    return BlockPlan(
        index=idx, dim=n, rank=rank, rank_max=max(1, rank_max),
        dense=bool(dense), m_loc=int(m_loc), loc2glob=loc2glob,
        pat_rows=pat_rows, pat_cols=pat_cols, c_pat=c_pat,
        a_con_loc=a_con_loc, a_pos=a_pos,
        a_val=blk.a_val.astype(np.float64),
    )


@dataclasses.dataclass
class BucketPlan:
    """A group of same-class blocks padded to common shapes (NumPy)."""

    dense: bool
    plans: List[BlockPlan]
    # padded shapes
    n: int
    K: int
    nnz_a: int
    m_loc: int
    rank: int        # current uniform rank for the bucket
    rank_max: int
    # stacked + padded arrays, leading axis B
    dims: np.ndarray          # int32 [B] true dims
    pat_rows: np.ndarray      # int32 [B, K]
    pat_cols: np.ndarray      # int32 [B, K]
    c_pat: np.ndarray         # f64   [B, K]
    a_pos: np.ndarray         # int32 [B, nnz_a]
    a_con_loc: np.ndarray     # int32 [B, nnz_a]
    a_val: np.ndarray         # f64   [B, nnz_a]
    a_diag_w: np.ndarray      # f64   [B, nnz_a]  (2 - is_diag) inner weights
    glob_idx: np.ndarray      # int32 [B, m_loc]  (padding -> m)

    @property
    def B(self) -> int:
        return len(self.plans)


def _dim_class(n: int) -> int:
    """Geometric size class: dims within 2x share a bucket."""
    return max(0, (n - 1).bit_length())


def bucketize(plans: List[BlockPlan], m: int,
              group: bool = True) -> List[BucketPlan]:
    """Group block plans into padded shape buckets."""
    groups: dict = {}
    for p in plans:
        key = (p.dense, _dim_class(p.dim)) if group else (p.index,)
        groups.setdefault(key, []).append(p)

    buckets = []
    for key in sorted(groups):
        ps = groups[key]
        B = len(ps)
        n = max(p.dim for p in ps)
        if ps[0].dense:
            # dense mode pads the pattern to the padded dim's full triangle
            K = n * (n + 1) // 2
        else:
            K = max(p.K for p in ps)
        nnz_a = max(p.nnz_a for p in ps)
        m_loc = max(p.m_loc for p in ps)
        rank = max(p.rank for p in ps)
        rank_max = max(p.rank_max for p in ps)

        pat_rows = np.zeros((B, K), dtype=np.int32)
        pat_cols = np.zeros((B, K), dtype=np.int32)
        c_pat = np.zeros((B, K), dtype=np.float64)
        a_pos = np.zeros((B, nnz_a), dtype=np.int32)
        a_con_loc = np.zeros((B, nnz_a), dtype=np.int32)
        a_val = np.zeros((B, nnz_a), dtype=np.float64)
        a_diag_w = np.zeros((B, nnz_a), dtype=np.float64)
        glob_idx = np.full((B, m_loc), m, dtype=np.int32)
        dims = np.zeros(B, dtype=np.int32)

        for b, p in enumerate(ps):
            dims[b] = p.dim
            if p.dense and p.dim < n:
                # re-plan the pattern on the padded triangle; slot of
                # (r, c) in the (col,row)-sorted lower triangle is
                # c*n - c(c-1)/2 + (r - c)
                pr, pc = _full_tri(n)

                def tri_slot(rr, cc):
                    rr = rr.astype(np.int64)
                    cc = cc.astype(np.int64)
                    return (cc * n - cc * (cc - 1) // 2
                            + (rr - cc)).astype(np.int32)

                pat_rows[b], pat_cols[b] = pr, pc
                cp = np.zeros(K)
                cp[tri_slot(p.pat_rows, p.pat_cols)] = p.c_pat
                c_pat[b] = cp
                apos = tri_slot(p.pat_rows[p.a_pos], p.pat_cols[p.a_pos])
            else:
                pat_rows[b, :p.K] = p.pat_rows
                pat_cols[b, :p.K] = p.pat_cols
                c_pat[b, :p.K] = p.c_pat
                apos = p.a_pos
            a_pos[b, :p.nnz_a] = apos
            a_con_loc[b, :p.nnz_a] = p.a_con_loc
            a_val[b, :p.nnz_a] = p.a_val
            a_diag_w[b, :p.nnz_a] = np.where(
                pat_rows[b][apos] == pat_cols[b][apos], 1.0, 2.0)
            glob_idx[b, :p.m_loc] = p.loc2glob

        buckets.append(BucketPlan(
            dense=ps[0].dense, plans=ps, n=n, K=K, nnz_a=nnz_a,
            m_loc=m_loc, rank=rank, rank_max=rank_max, dims=dims,
            pat_rows=pat_rows, pat_cols=pat_cols, c_pat=c_pat,
            a_pos=a_pos, a_con_loc=a_con_loc, a_val=a_val,
            a_diag_w=a_diag_w, glob_idx=glob_idx,
        ))
    return buckets


def _full_tri(n: int):
    """Lower-triangle coordinates sorted by (col, row)."""
    cols, rows = [], []
    for c in range(n):
        for r in range(c, n):
            rows.append(r)
            cols.append(c)
    return np.asarray(rows, dtype=np.int32), np.asarray(cols, dtype=np.int32)


@dataclasses.dataclass
class Presolved:
    """Everything the device solver needs, still on host (NumPy)."""

    problem: SDPProblem
    plans: List[BlockPlan]
    buckets: List[BucketPlan]
    # DIMACS norm constants (lorads_solver.c:1054-1073)
    c_nrm1: float
    c_nrm2: float
    c_nrm_inf: float
    b_nrm1: float
    b_nrm2: float
    b_nrm_inf: float
    rho0: float

    @property
    def m(self) -> int:
        return self.problem.m


def presolve(problem: SDPProblem, params: LoradsParams,
             group: bool = True) -> Presolved:
    n_cones = problem.n_sdp_blocks
    plans = [plan_block(i, b, params, n_cones)
             for i, b in enumerate(problem.blocks)]
    buckets = bucketize(plans, problem.m, group=group)

    # initial rho = 1/sqrt(sum blkDims) if initRho == 0
    # (lorads_solver.c:1155-1164)
    if params.init_rho == 0:
        rho0 = 1.0 / math.sqrt(max(problem.sum_block_dims, 1))
    else:
        rho0 = params.init_rho

    return Presolved(
        problem=problem, plans=plans, buckets=buckets,
        c_nrm1=problem.obj_nrm1(), c_nrm2=problem.obj_nrm2(),
        c_nrm_inf=problem.obj_nrm_inf(),
        b_nrm1=problem.rhs_nrm1(), b_nrm2=problem.rhs_nrm2(),
        b_nrm_inf=problem.rhs_nrm_inf(), rho0=rho0,
    )
