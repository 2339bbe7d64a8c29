"""Union-pattern constraint kernels (the hot path).

The one load-bearing trick inherited from the reference: X = UV^T is
never materialized globally — `LORADSUVt` computes (UV^T + VU^T)/2 only
at the union sparsity pattern of {C, A_1..A_m} per block
(/root/reference/src_semi/lorads_alg/lorads_alg_common.c:21-68), and all
constraint inner products <A_i, X>, adjoints A^*(w) and products W.R
operate on those pattern values
(/root/reference/src_semi/data/lorads_sdp_conic.c:285-292, 437-445;
lorads_sdp_data.c:491-732).

Device mapping (all ops batched over the bucket axis B):

* dense-mode blocks: UV^T and W.R via dense matrix products, A(X)
  and A^*(w) via one flat gather / segment-sum each;
* sparse-mode blocks: UV^T on the pattern via row gathers + batched
  elementwise row-dots, W.R via two gather/segment-sum contractions.

Batched segment sums use the index-offset trick (ids + b*S, one global
scatter) which XLA lowers to a single sorted scatter per call.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from lorads_tpu.core.presolve import BucketPlan


# f64 segment sums route through cumsum + static boundary gathers when
# boundaries are available (see bounded_segment_sum).  Module switch
# kept for experiments/ablations.
CUMSUM_F64 = True

# f32 gradient-path products (cmul) may also take the scatter-free
# cumsum route, whose error O(eps |prefix|) ~ 1e-5 relative is
# acceptable for L-BFGS directions / line-search coefficients, NOT for
# the DIMACS-critical constraint sums (which keep the scatter at f32).
CUMSUM_F32_GRAD = True

# Round 5: COMPENSATED (TwoSum pair) scan segment sums.  When on,
# every bounds-eligible sorted segment sum — at f32 AND f64 — runs
# scatter-free through comp_segment_sum: prefix sums carried as an
# unevaluated (hi, lo) f32 pair whose boundary differences recover
# the segment sum to ~eps32 |segment| (f32 in) or ~2^-47 |prefix|
# (f64 in, split_f64).  Its f32 error matches the scatter it
# replaces (eps |segment| per output) and it has no scatter at all,
# so DIMACS-critical constraint sums take it as well.  False restores
# the scatter policy (CUMSUM_F64 / CUMSUM_F32_GRAD).
COMP_CUMSUM = True


def _twosum(a, b):
    """Knuth TwoSum: s = fl(a + b) and the EXACT rounding error e,
    a + b == s + e in exact arithmetic.  6 IEEE flops, branch-free;
    relies on XLA not reassociating f32 adds — checked on the CPU by
    test_kernels.test_comp_segment_sum_accuracy and on the GPU by
    chip_smoke.py's compensated-sum comparison, both of which fail
    loudly if a simplifier ever folds e to zero)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def split_f64(x):
    """Split f64 ``x`` into two f32 planes with hi + lo = x up to
    2^-47 |x|: hi is x with its 29 low mantissa bits cleared (exact in
    f32), lo = f32(x - hi).  The split masks bits instead of rounding
    through f32 and back: XLA:GPU's excess-precision simplification
    (on by default) folds an f64 -> f32 -> f64 convert pair to the
    identity, which silently zeroed lo and left f64 sums with f32
    accuracy."""
    mask = jnp.uint64(0xFFFFFFFFE0000000)
    hi = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(x, jnp.uint64) & mask, jnp.float64)
    return hi.astype(jnp.float32), (x - hi).astype(jnp.float32)


def _shift1(x, k, axis):
    """x shifted +k along ``axis`` with zero fill (contiguous pad +
    slice, no strided even/odd slicing)."""
    pads = [(0, 0)] * x.ndim
    pads[axis] = (k, 0)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, x.shape[axis])
    return jnp.pad(x, pads)[tuple(sl)]


def _hs_pair_scan(hi, lo, axis):
    """Inclusive pair prefix scan via Hillis-Steele contiguous
    shifts: log2(N) steps of x[i] <- x[i] (+) x[i-2^j] with the
    TwoSum pair combine."""
    N = hi.shape[axis]
    k = 1
    while k < N:
        sh, sl_ = _shift1(hi, k, axis), _shift1(lo, k, axis)
        s, e = _twosum(hi, sh)
        hi, lo = s, lo + sl_ + e
        k *= 2
    return hi, lo


_PAIR_CHUNK = 512

# cmul slices its full-symmetric entry list into chunks of this many
# entries when the list exceeds 2x the value (peak-memory bound for the
# [B, chunk, r] gather/scan transients at maxcut n >= 500000)
_CMUL_CHUNK = 4_000_000


def _pair_scan(hi, lo, axis=1):
    """Inclusive prefix sums of hi + lo carried as a running f32
    two-float pair: the hi lane advances by TwoSum (error pushed into
    lo), lo accumulates compensations in plain f32.  Error of the pair
    sum vs the exact prefix is O(eps^2 N |prefix|) — f64-grade for any
    pattern size here (N < 2^24).

    Implementation: TWO-LEVEL Hillis-Steele — within-chunk pair scans
    of length _PAIR_CHUNK plus a pair scan over the chunk totals, all
    shifts contiguous pads.  `lax.associative_scan` with the same
    combine lowers its even/odd recursion to strided slices and
    compiles slowly in its 3D form; docs/DESIGN.md keeps the history.
    """
    assert axis == 1
    B, N = hi.shape[0], hi.shape[1]
    if N <= 2 * _PAIR_CHUNK:
        return _hs_pair_scan(hi, lo, axis)
    trail = hi.shape[2:]
    L = _PAIR_CHUNK
    nc = -(-N // L)
    pads = [(0, 0), (0, nc * L - N)] + [(0, 0)] * len(trail)
    hi = jnp.pad(hi, pads).reshape((B, nc, L) + trail)
    lo = jnp.pad(lo, pads).reshape((B, nc, L) + trail)
    wh, wl = _hs_pair_scan(hi, lo, axis=2)
    ph, pl = _hs_pair_scan(wh[:, :, -1], wl[:, :, -1], axis=1)
    eh, el = _shift1(ph, 1, 1), _shift1(pl, 1, 1)   # exclusive
    s, e = _twosum(wh, eh[:, :, None])
    oh, ol = s, wl + el[:, :, None] + e
    oh = oh.reshape((B, nc * L) + trail)[:, :N]
    ol = ol.reshape((B, nc * L) + trail)[:, :N]
    return oh, ol


def comp_segment_sum(data: jnp.ndarray,
                     bounds: jnp.ndarray) -> jnp.ndarray:
    """Compensated scatter-free sorted segment sum (see COMP_CUMSUM).

    ``data`` [B, N, ...] ordered so segment j occupies rows
    [bounds[b, j], bounds[b, j+1]); ``bounds`` [B, S+1] static.
    f32 in -> f32 out with error ~ eps32 |segment| (the raw f32 cumsum
    difference is eps32 |prefix| — unusable); f64 in -> f64 out via a
    split into two f32 planes (split_f64), error ~ 2^-47 |prefix|
    (assumes |data| is f32-representable, which presolve's scaling
    guarantees — same contract as the a_lin2_exact two-plane scatter).
    """
    f64 = data.dtype == jnp.float64
    if f64:
        hi, lo = split_f64(data)
    else:
        hi, lo = data, jnp.zeros_like(data)
    ph, pl = _pair_scan(hi, lo)
    z = jnp.zeros_like(ph[:, :1])
    ph = jnp.concatenate([z, ph], axis=1)
    pl = jnp.concatenate([z, pl], axis=1)
    idx = bounds
    if data.ndim == 3:
        idx = idx[:, :, None]
    gh = jnp.take_along_axis(ph, idx, axis=1)
    gl = jnp.take_along_axis(pl, idx, axis=1)
    if f64:
        g = gh.astype(jnp.float64) + gl.astype(jnp.float64)
        return g[:, 1:] - g[:, :-1]
    # f32: difference the pairs with the subtraction error recovered
    d, e = _twosum(gh[:, 1:], -gh[:, :-1])
    return d + (e + (gl[:, 1:] - gl[:, :-1]))


def bounded_segment_sum(data: jnp.ndarray,
                        bounds: jnp.ndarray) -> jnp.ndarray:
    """Sorted segment sum as a difference of prefix sums.

    ``data`` [B, N, ...] is ordered so that segment j occupies rows
    [bounds[b, j], bounds[b, j+1]); ``bounds`` [B, S+1] is STATIC
    (precomputed from the pattern at build time).  Then

        csum = concat(0, cumsum(data, axis=1))
        out[b, j] = csum[b, bounds[j+1]] - csum[b, bounds[j]]

    — one cumsum + two gathers, no scatter.  Error is
    O(eps * |prefix|) per output — ~1e-16 * ||data||_1 at f64, far
    below any tolerance here; at f32 that error model is WORSE than
    the scatter's per-segment rounding, so f32 keeps the scatter.
    """
    cs = jnp.cumsum(data, axis=1)
    cs = jnp.concatenate([jnp.zeros_like(cs[:, :1]), cs], axis=1)
    idx = bounds
    if data.ndim == 3:
        idx = idx[:, :, None]
    g = jnp.take_along_axis(cs, idx, axis=1)
    return g[:, 1:] - g[:, :-1]


def _use_bounds(data: jnp.ndarray, bounds, f32_ok: bool = False) -> bool:
    """The bounded path is taken iff the boundary gathers don't dwarf
    the scatter it replaces: S+1 output gathers vs N scattered rows.

    With COMP_CUMSUM on (default), any dtype qualifies — the
    compensated pair scan's error ~ eps |segment| matches the
    scatter's, so even DIMACS-critical sums take it.  f32_ok only
    matters in the round-4 fallback policy: the caller is a
    gradient-path product where the raw f32 cumsum's O(eps |prefix|)
    error is acceptable (see CUMSUM_F32_GRAD)."""
    if bounds is None or bounds.shape[-1] > 2 * data.shape[1] + 1:
        return False
    if COMP_CUMSUM:
        return True
    if data.dtype == jnp.float64:
        return CUMSUM_F64
    return f32_ok and CUMSUM_F32_GRAD


def single_segment_sum(data: jnp.ndarray,
                       bounds: jnp.ndarray) -> jnp.ndarray:
    """Segment sum when every segment statically holds <= 1 entry:
    out[b, j] = data[b, bounds[b, j]] masked by segment non-emptiness.
    EXACT at any dtype (no summation happens at all) and a pure
    gather."""
    idx = bounds[:, :-1]
    has = (bounds[:, 1:] > bounds[:, :-1]).astype(data.dtype)
    if data.ndim == 3:
        g = jnp.take_along_axis(data, idx[:, :, None], axis=1,
                                mode="clip")
        return g * has[:, :, None]
    g = jnp.take_along_axis(data, idx, axis=1, mode="clip")
    return g * has


def batched_segment_sum(data: jnp.ndarray, ids: jnp.ndarray,
                        num_segments: int,
                        sorted_ids: bool = False,
                        bounds=None,
                        f32_bounds: bool = False,
                        single: bool = False,
                        shard_batch: bool = False) -> jnp.ndarray:
    """segment_sum along axis 1 of [B, N, ...] with ids [B, N].

    The block-offset trick keeps global sortedness whenever each
    block's ids are non-decreasing, letting XLA use its sorted-scatter
    fast path (pass sorted_ids=True then — it is a static promise).

    ``bounds`` [B, num_segments+1]: static per-block segment boundary
    indices (only valid for per-block-sorted ids); f64 data then takes
    the scatter-free bounded_segment_sum path.
    """
    if single and bounds is not None:
        # exact masked boundary-gather; partitions along a sharded
        # batch axis like bounded_segment_sum (batch-independent ops)
        return single_segment_sum(data, bounds)
    if _use_bounds(data, bounds, f32_ok=f32_bounds):
        # Taken even when shard_batch is set: scan + boundary
        # gathers are batch-independent, so GSPMD partitions this path
        # along a sharded axis 0 with zero collectives (verified by
        # test_sharded.test_bounded_segment_sum_partitions_cleanly).
        if COMP_CUMSUM:
            return comp_segment_sum(data, bounds)
        return bounded_segment_sum(data, bounds)
    if shard_batch:
        # keep the batch axis a REAL dimension (vmapped per-block
        # scatter) instead of flattening it into the scatter space:
        # when axis 0 is mesh-sharded (rowshard/summed buckets), the
        # flattened scatter's ids cross shard boundaries and GSPMD
        # replicates the whole scatter (measured: an all-gather of the
        # ids + an all-reduce of the updates per iteration); the
        # vmapped form partitions trivially along axis 0.
        return jax.vmap(
            lambda d, i: jax.ops.segment_sum(
                d, i, num_segments=num_segments,
                indices_are_sorted=sorted_ids))(data, ids)
    B = data.shape[0]
    offset = (jnp.arange(B, dtype=ids.dtype) * num_segments)[:, None]
    flat_ids = (ids + offset).reshape(-1)
    flat = data.reshape((-1,) + data.shape[2:])
    out = jax.ops.segment_sum(flat, flat_ids,
                              num_segments=B * num_segments,
                              indices_are_sorted=sorted_ids)
    return out.reshape((B, num_segments) + data.shape[2:])


def take_rows(X: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather rows: X [B, n, r], idx [B, K] -> [B, K, r]."""
    return jnp.take_along_axis(X, idx[:, :, None], axis=1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BucketData:
    """Device-resident static data for one bucket of same-shape blocks.

    Shapes: B blocks, dim n (padded), pattern size K, nnz_a constraint
    entries, m_loc local constraint slots.
    """

    # -- static metadata --
    dense: bool = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    K: int = dataclasses.field(metadata=dict(static=True))
    nnz_a: int = dataclasses.field(metadata=dict(static=True))
    m_loc: int = dataclasses.field(metadata=dict(static=True))
    B: int = dataclasses.field(metadata=dict(static=True))
    m_glob: int = dataclasses.field(metadata=dict(static=True))

    # -- common arrays --
    a_con_loc: jnp.ndarray   # int32 [B, nnz_a]
    a_val_inner: jnp.ndarray  # [B, nnz_a]: a_val * (2 - is_diag)
    glob_idx: jnp.ndarray    # int32 [B, m_loc] (padding -> m_glob)

    # -- sparse-mode arrays (placeholders in dense mode) --
    pat_rows: jnp.ndarray    # int32 [B, K]
    pat_cols: jnp.ndarray    # int32 [B, K]
    c_pat: jnp.ndarray       # [B, K] entry values of C
    c_pat_inner: jnp.ndarray  # [B, K]: c_pat * (2 - is_diag)
    pat_offdiag: jnp.ndarray  # [B, K] 1.0 where row != col else 0.0
    a_pos: jnp.ndarray       # int32 [B, nnz_a] into the pattern

    # -- dense-mode arrays (placeholders in sparse mode) --
    a_lin: jnp.ndarray       # int32 [B, nnz_a] = row*n + col
    a_lin_t: jnp.ndarray     # int32 [B, nnz_a] = col*n + row
    a_val: jnp.ndarray       # [B, nnz_a] raw entry values
    a_val_mirror: jnp.ndarray  # [B, nnz_a] raw values, 0 on diagonal
    c_full: jnp.ndarray      # [B, n, n] dense symmetric C

    # -- pre-permuted copies so every scatter is sorted --
    # build_w: entries re-ordered by pattern slot (free: static perm)
    a_pos_s: jnp.ndarray = None      # int32 [B, nnz_a], sorted per block
    a_con_loc_s: jnp.ndarray = None  # int32 [B, nnz_a]
    a_val_s: jnp.ndarray = None      # [B, nnz_a]
    # w_mul lower pass: pattern re-ordered by row
    row_perm: jnp.ndarray = None     # int32 [B, K]
    pat_rows_s: jnp.ndarray = None   # int32 [B, K], sorted per block
    pat_cols_rp: jnp.ndarray = None  # int32 [B, K] = pat_cols[row_perm]

    # -- static per-block-sortedness promises (XLA sorted-scatter
    #    fast path in batched_segment_sum) --
    a_con_sorted: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    a_pos_sorted: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    pat_rows_sorted: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    pat_cols_sorted: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    glob_sorted: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # single block whose local constraint slots ARE the global slots
    # (loc2glob == arange(m)): scatter_constr / gather_w are identity
    glob_ident: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    # -- static segment boundaries for every sorted scatter --
    # bnd_X [B, S+1] holds searchsorted(X_ids, 0..S) per block, so a
    # sorted segment sum becomes cumsum + boundary-gather diffs
    # (bounded_segment_sum) — the scatter-free path f64 data takes.
    bnd_a_con: jnp.ndarray = None       # [B, m_loc+1]  (a_con_loc)
    # every segment holds at most ONE entry (statically): the segment
    # sum is an exact masked boundary-GATHER at any dtype (the
    # matcomp families' constraints are all single-entry)
    a_con_single: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    bnd_a_pos_s: jnp.ndarray = None     # [B, K+1]      (a_pos_s)
    bnd_pat_rows_s: jnp.ndarray = None  # [B, n+1]      (pat_rows_s)
    bnd_pat_cols: jnp.ndarray = None    # [B, n+1]      (pat_cols)
    bnd_glob: jnp.ndarray = None        # [B, m_glob+2] (glob_idx)
    # dense mode: statically sorted concat(a_lin, a_lin_t) scatter
    a_lin2_perm: jnp.ndarray = None     # int32 [B, 2*nnz_a]
    bnd_a_lin2: jnp.ndarray = None      # [B, n*n+1]
    # every W slot receives at most ONE (statically) nonzero entry:
    # the f64 build_w scatter can then run as two exact f32 planes
    a_lin2_exact: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # dense-mode A^*(A(.)) fusion: every constraint is either a single
    # (off-)diagonal entry or touches only the diagonal (theta: edges
    # + trace) — then A^*(A(X)) = a2_full .* X plus a small diagonal
    # composition (a_adj_a_dense)
    a_single_dense: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    a2_full: jnp.ndarray = None       # [B, n, n] sum 2 a^2 (mirrored)
    dd_con: jnp.ndarray = None        # int32 [B, nnz_dd] diag-only cons
    dd_row: jnp.ndarray = None        # int32 [B, nnz_dd]
    dd_val: jnp.ndarray = None        # [B, nnz_dd]
    nnz_dd: int = dataclasses.field(default=0, metadata=dict(static=True))

    # ------------------------------------------------------------------
    # summed: the B axis is a SHARD axis of one logical cone (pattern
    # sharding, parallel/pattern_sharded.py), not independent blocks.
    # Factors come in as [1, n, r] (replicated), are broadcast to
    # [B, n, r] on kernel entry, and factor-shaped outputs (w_mul) are
    # summed back to [1, n, r] — under a NamedSharding mesh placement
    # GSPMD turns that sum into a psum across the devices.  Constraint-value
    # outputs stay per-shard PARTIALS; scatter_constr's global sum
    # already reduces over B.  Semantics are placement-independent:
    # a summed bucket computes exactly what the unsharded single-block
    # bucket computes (tested on CPU without a mesh).
    # ------------------------------------------------------------------
    summed: bool = dataclasses.field(default=False,
                                     metadata=dict(static=True))

    # ------------------------------------------------------------------
    # rowshard: dense-mode row-slab (tensor-parallel-style) sharding of
    # ONE logical cone (parallel/row_sharded.build_rowshard_bucket).
    # The B axis is the shard axis; device d owns rows
    # [d*n_loc, (d+1)*n_loc) of every n x n intermediate:
    #   * c_full is the FULL-SYMMETRIC C row slab [D, n_loc, n]
    #   * constraint entries are stored in full-symmetric form and
    #     assigned to the shard owning their ROW; a_lin = loc_row*n+col
    #     indexes the slab (a_val_inner = raw values: mirrors are
    #     listed, so no 2x diagonal weighting)
    #   * uvt/build_w produce [D, n_loc, n] slabs (row-sharded dsyr2k /
    #     scatter; reference fds_syr2k lorads_dense_opts.c:529-539)
    #   * w_mul is the row-sharded dsymm (lorads_sdp_data.c:646-671):
    #     disjoint [D, n_loc, r] products reshaped back to [1, n, r] —
    #     an all_gather under mesh placement
    #   * constraint values are per-shard PARTIALS [D, m_loc] summed by
    #     scatter_constr / cone_total, exactly like summed buckets.
    # Factors stay replicated [1, n, r]; the n x n objects never
    # materialize on one device (per-chip ceiling n^2/D).  Semantics
    # are placement-independent: equals the unsharded dense bucket.
    # ------------------------------------------------------------------
    rowshard: bool = dataclasses.field(default=False,
                                       metadata=dict(static=True))
    n_loc: int = dataclasses.field(default=0, metadata=dict(static=True))
    # Mesh the shard axis lives on (rowshard/summed buckets placed by
    # solver._maybe_shard).  Static aux data: kernels use it to PIN
    # the intended placement via with_sharding_constraint — factors
    # replicated, slabs/partials on the "blk" axis.  Without the pins
    # GSPMD reshards the ALM loop carry row-wise and re-gathers the
    # [n, r] factors at every slab einsum (measured: 27 all-reduces +
    # 14 all-gathers per inner iteration at D=2; the intended pattern
    # is ~4 + 2).  None = unsharded (constraints are no-ops).
    mesh: object = dataclasses.field(default=None,
                                     metadata=dict(static=True))

    # ------------------------------------------------------------------
    # Diag/offdiag split (sparse mode only, split=True).
    #
    # The diagonal of sym(UV^T) is rowsum(U*V) — a dense elementwise op — so
    # splitting the union pattern into its diagonal (dense [B, n]
    # vectors) and strictly-lower entries removes every gather/scatter
    # the diagonal used to cost.  For diagonal-constrained families
    # (Max-Cut: A_i = e_i e_i^T) the whole constraint path becomes
    # dense elementwise work (diag_ident), eliminating A(UV^T) and
    # A^*(w) gathers entirely.  Reference semantics unchanged
    # (lorads_alg_common.c:21-68 computes the same values).
    # ------------------------------------------------------------------
    split: bool = dataclasses.field(default=False,
                                    metadata=dict(static=True))
    diag_ident: bool = dataclasses.field(default=False,
                                         metadata=dict(static=True))
    # summed (pattern-sharded) bucket whose PARENT cone is
    # diag-identity: per-shard diag_ident is necessarily False (each
    # shard holds a slice of the diagonal), but the aop diag-fast path
    # still applies with the replicated full diagonal map below
    diag_parent: bool = dataclasses.field(default=False,
                                          metadata=dict(static=True))
    a_val_d_full: jnp.ndarray = None  # [B, n] full diag coefficients
    #                                   (replicated copies per shard)
    has_diag_a: bool = dataclasses.field(default=False,
                                         metadata=dict(static=True))
    has_off_a: bool = dataclasses.field(default=False,
                                        metadata=dict(static=True))
    has_off: bool = dataclasses.field(default=False,
                                      metadata=dict(static=True))
    Ko: int = dataclasses.field(default=0, metadata=dict(static=True))
    nnz_d: int = dataclasses.field(default=0, metadata=dict(static=True))
    nnz_o: int = dataclasses.field(default=0, metadata=dict(static=True))
    off_rows: jnp.ndarray = None      # int32 [B, Ko] strictly-lower rows
    off_cols: jnp.ndarray = None      # int32 [B, Ko]
    c_off: jnp.ndarray = None         # [B, Ko] C values at off entries
    c_off2: jnp.ndarray = None        # [B, Ko] = 2 * c_off
    c_diag: jnp.ndarray = None        # [B, n] dense diagonal of C
    # every off constraint entry owns a DISTINCT pattern slot and a
    # DISTINCT constraint (matcomp observations, theta edges), and no
    # constraint mixes diag and off entries: A^*(A(.)) is then
    # slot-diagonal on the off pattern (a_adj_a)
    a_off_unique: bool = dataclasses.field(default=False,
                                           metadata=dict(static=True))
    a2_off: jnp.ndarray = None        # [B, Ko] 2*a_val^2 at slot order
    a2_off_cp: jnp.ndarray = None     # [B, Ko] col-order mirror
    # diagonal constraint entries
    a_con_d: jnp.ndarray = None       # int32 [B, nnz_d]
    a_row_d: jnp.ndarray = None       # int32 [B, nnz_d]
    a_val_d: jnp.ndarray = None       # [B, nnz_d]
    # off-diagonal constraint entries (values pre-doubled for <A,X>)
    a_con_o: jnp.ndarray = None       # int32 [B, nnz_o]
    a_pos_o: jnp.ndarray = None       # int32 [B, nnz_o] into off arrays
    a_val_o: jnp.ndarray = None       # [B, nnz_o] raw values
    # pre-permuted copies for sorted scatters
    a_pos_o_s: jnp.ndarray = None     # sorted per block
    a_con_o_s: jnp.ndarray = None
    a_val_o_s: jnp.ndarray = None
    off_row_perm: jnp.ndarray = None  # int32 [B, Ko]
    off_rows_s: jnp.ndarray = None    # rows sorted per block
    off_cols_rp: jnp.ndarray = None   # cols re-ordered by off_row_perm
    a_row_d_s: jnp.ndarray = None     # diag entries sorted by row
    a_val_d_s: jnp.ndarray = None
    a_con_d_s: jnp.ndarray = None
    # ---- column-sorted mirror of the off pattern ----
    # Scatters at unsorted ids pay random-access latency while sorted
    # ids ride locality; the upper-half scatter of W @ X (via
    # off_cols) is the single hottest op in both the ALM gradient and
    # the ADMM CG matvec.  The mirror gives it
    # sorted ids: maintain a third cache X[off_rows_cp] (col-order) and
    # scatter W_o_co * that at off_cols_sp.  W's off values in
    # col-order come from statically remapped constraint-entry indices
    # (a_pos_o_co_s), never a runtime permutation.
    off_col_perm: jnp.ndarray = None  # int32 [B, Ko] argsort(off_cols)
    off_cols_sp: jnp.ndarray = None   # int32 [B, Ko] sorted cols
    off_rows_cp: jnp.ndarray = None   # int32 [B, Ko] rows in col-order
    c_off_cp: jnp.ndarray = None      # [B, Ko] C off values, col-order
    a_pos_o_co_s: jnp.ndarray = None  # int32 [B, nnz_o] col-order slots
    a_con_o_co_s: jnp.ndarray = None  # int32 [B, nnz_o]
    a_val_o_co_s: jnp.ndarray = None  # [B, nnz_o]
    # sortedness promises for the split arrays
    off_rows_sorted: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    off_cols_sorted: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    a_con_d_sorted: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    a_con_o_sorted: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # segment boundaries for the split-mode sorted scatters
    # full-symmetric C entry list sorted by row: cmul's single-pass
    # form (one gather + one segment sum over 2*Ko entries instead of
    # a lower pass + a col-mirror pass)
    Ks: int = dataclasses.field(default=0, metadata=dict(static=True))
    sym_rows_rs: jnp.ndarray = None      # int32 [B, Ks] row-sorted
    sym_cols_rs: jnp.ndarray = None      # int32 [B, Ks]
    c_sym_rs: jnp.ndarray = None         # [B, Ks] C values
    bnd_sym_rows: jnp.ndarray = None     # [B, n+1]
    bnd_a_con_d: jnp.ndarray = None      # [B, m_loc+1] (a_con_d)
    bnd_a_con_o: jnp.ndarray = None      # [B, m_loc+1] (a_con_o)
    # single-entry-segment flags (see a_con_single)
    a_con_d_single: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    a_con_o_single: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    bnd_a_row_d_s: jnp.ndarray = None    # [B, n+1]     (a_row_d_s)
    bnd_a_pos_o_s: jnp.ndarray = None    # [B, Ko+1]    (a_pos_o_s)
    bnd_a_pos_o_co_s: jnp.ndarray = None  # [B, Ko+1]   (a_pos_o_co_s)
    bnd_off_rows: jnp.ndarray = None     # [B, n+1]     (off_rows)
    bnd_off_rows_s: jnp.ndarray = None   # [B, n+1]     (off_rows_s)
    bnd_off_cols_sp: jnp.ndarray = None  # [B, n+1]     (off_cols_sp)


def _rows_sorted(x: np.ndarray) -> bool:
    return bool(np.all(np.diff(x, axis=1) >= 0)) if x.size else True


def _single_ids(ids: np.ndarray) -> bool:
    """True iff every per-block-sorted id appears at most once (each
    segment then holds <= 1 entry; see single_segment_sum)."""
    if ids.size == 0:
        return True
    return bool(np.all(np.diff(ids, axis=1) >= 1))


def _bounds_np(ids: np.ndarray, S: int) -> jnp.ndarray:
    """Static segment boundaries [B, S+1] of per-block-sorted ids:
    bnd[b, j] = first position in ids[b] with value >= j."""
    B = ids.shape[0]
    out = np.zeros((B, S + 1), np.int32)
    r = np.arange(S + 1)
    for b in range(B):
        out[b] = np.searchsorted(ids[b], r)
    return jnp.asarray(out, jnp.int32)


def _build_split_fields(bp: BucketPlan, dtype,
                        want_sym: bool = False) -> dict:
    """Host construction of the diag/offdiag split arrays (sparse mode).

    See BucketData.split.  Also detects the diag-identity structure
    (constraint i == diagonal entry i, the Max-Cut shape) that makes
    the whole constraint path dense.
    """
    B, n = bp.B, bp.n
    per_off, per_ad, per_ao = [], [], []
    c_diag = np.zeros((B, n))
    ident = True
    for b in range(B):
        pr = bp.pat_rows[b].astype(np.int64)
        pc = bp.pat_cols[b].astype(np.int64)
        cp = bp.c_pat[b]
        is_d = pr == pc
        off_idx = np.nonzero(~is_d)[0]
        off_of = np.full(pr.size, 0, np.int64)
        off_of[off_idx] = np.arange(off_idx.size)
        np.add.at(c_diag[b], pr[is_d], cp[is_d])
        per_off.append((pr[off_idx], pc[off_idx], cp[off_idx]))

        ap = bp.a_pos[b].astype(np.int64)
        ac = bp.a_con_loc[b].astype(np.int64)
        av = bp.a_val[b]
        ed = is_d[ap]
        con_d, row_d, val_d = ac[ed], pr[ap[ed]], av[ed]
        # order diag entries by constraint slot (enables the identity
        # fast path and a deterministic layout)
        od = np.argsort(con_d, kind="stable")
        con_d, row_d, val_d = con_d[od], row_d[od], val_d[od]
        per_ad.append((con_d, row_d, val_d))
        eo = ~ed
        per_ao.append((ac[eo], off_of[ap[eo]], av[eo]))

        p = bp.plans[b]
        # "identity" demands constraints be PURE diagonal entries: a
        # constraint mixing its diag entry with off-diagonal entries
        # breaks every diag-fast consumer (aop._diag_fast treats
        # A^*(w) as diagonal; the ADMM closed-form solve assumes a
        # row-decoupled normal operator).
        ident &= (p.dim == n and p.m_loc == n and con_d.size == n
                  and ac[eo].size == 0
                  and bool(np.all(con_d == np.arange(n)))
                  and bool(np.all(row_d == np.arange(n))))

    Ko = max(max(o[0].size for o in per_off), 1)
    nnz_d = max(max(a[0].size for a in per_ad), 1)
    nnz_o = max(max(a[0].size for a in per_ao), 1)
    ident = ident and all(a[0].size == nnz_d for a in per_ad)

    def padi(seqs, L):
        out = np.zeros((B, L), np.int32)
        for b, s in enumerate(seqs):
            out[b, :s.size] = s
        return out

    def padf(seqs, L):
        out = np.zeros((B, L))
        for b, s in enumerate(seqs):
            out[b, :s.size] = s
        return out

    off_rows = padi([o[0] for o in per_off], Ko)
    off_cols = padi([o[1] for o in per_off], Ko)
    c_off = padf([o[2] for o in per_off], Ko)
    a_con_d = padi([a[0] for a in per_ad], nnz_d)
    a_row_d = padi([a[1] for a in per_ad], nnz_d)
    a_val_d = padf([a[2] for a in per_ad], nnz_d)
    a_con_o = padi([a[0] for a in per_ao], nnz_o)
    a_pos_o = padi([a[1] for a in per_ao], nnz_o)
    a_val_o = padf([a[2] for a in per_ao], nnz_o)

    # static permutations for sorted scatters
    po = np.argsort(a_pos_o, axis=1, kind="stable")
    rp = np.argsort(off_rows, axis=1, kind="stable")
    rd = np.argsort(a_row_d, axis=1, kind="stable")

    # column-sorted mirror (see BucketData comment).  Padding slots
    # (beyond each block's true Ko) carry col 0 / row 0 / value 0 and
    # sort to the front; scattering zeros there is harmless.
    cp = np.argsort(off_cols, axis=1, kind="stable")
    ta = np.take_along_axis
    inv_cp = np.empty_like(cp)
    np.put_along_axis(inv_cp, cp, np.broadcast_to(
        np.arange(Ko, dtype=cp.dtype), cp.shape).copy(), axis=1)
    a_pos_o_co = ta(inv_cp, a_pos_o, 1)
    pco = np.argsort(a_pos_o_co, axis=1, kind="stable")

    f = lambda x: jnp.asarray(x, dtype=dtype)
    i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)

    # A^*(A(.)) slot-diagonal detection (see BucketData.a_off_unique):
    # per block, every off constraint entry has a distinct slot and a
    # distinct constraint, and diag/off constraint sets are disjoint
    off_unique = True
    a2_off = np.zeros((B, Ko))
    for b, ((con_o, pos_o, val_o), (con_d, _, _)) in enumerate(
            zip(per_ao, per_ad)):
        ok = (np.unique(pos_o).size == pos_o.size
              and np.unique(con_o).size == con_o.size
              and not np.intersect1d(con_o, con_d).size)
        off_unique &= bool(ok)
        np.add.at(a2_off[b], pos_o, 2.0 * val_o ** 2)
    a2_off_cp = np.take_along_axis(a2_off, cp, axis=1)

    # full-symmetric C entries (lower + mirror) sorted by row, padded
    # per block; pad slots carry (row 0, col 0, value 0) — harmless.
    # Only consumed by cmul (the diag-identity / diag-parent fast
    # path), so only built where that path can run.
    sym_fields = dict(Ks=0)
    if ident or want_sym:
        Ks = max(2 * max(o[0].size for o in per_off), 1)
        sym_rows = np.zeros((B, Ks), np.int64)
        sym_cols = np.zeros((B, Ks), np.int64)
        sym_vals = np.zeros((B, Ks))
        for b, (orow, ocol, oval) in enumerate(per_off):
            k2 = 2 * orow.size
            sr = np.concatenate([orow, ocol])
            sc = np.concatenate([ocol, orow])
            sv = np.concatenate([oval, oval])
            o_rs = np.argsort(sr, kind="stable")
            sym_rows[b, :k2] = sr[o_rs]
            sym_cols[b, :k2] = sc[o_rs]
            sym_vals[b, :k2] = sv[o_rs]
            # keep padding sorted too (zero pad rows sort to the front)
            row_sorted = np.argsort(sym_rows[b], kind="stable")
            sym_rows[b] = sym_rows[b][row_sorted]
            sym_cols[b] = sym_cols[b][row_sorted]
            sym_vals[b] = sym_vals[b][row_sorted]
        sym_fields = dict(
            Ks=Ks, sym_rows_rs=i32(sym_rows), sym_cols_rs=i32(sym_cols),
            c_sym_rs=f(sym_vals), bnd_sym_rows=_bounds_np(sym_rows, n))

    return dict(
        split=True, diag_ident=bool(ident), Ko=Ko, nnz_d=nnz_d,
        a_off_unique=bool(off_unique and any(o[0].size for o in per_ao)),
        a2_off=f(a2_off), a2_off_cp=f(a2_off_cp),
        **sym_fields,
        nnz_o=nnz_o,
        has_diag_a=any(a[0].size for a in per_ad),
        has_off_a=any(a[0].size for a in per_ao),
        has_off=any(o[0].size for o in per_off),
        off_rows=i32(off_rows), off_cols=i32(off_cols),
        c_off=f(c_off), c_off2=f(2.0 * c_off), c_diag=f(c_diag),
        a_con_d=i32(a_con_d), a_row_d=i32(a_row_d), a_val_d=f(a_val_d),
        a_con_o=i32(a_con_o), a_pos_o=i32(a_pos_o), a_val_o=f(a_val_o),
        a_pos_o_s=i32(ta(a_pos_o, po, 1)),
        a_con_o_s=i32(ta(a_con_o, po, 1)),
        a_val_o_s=f(ta(a_val_o, po, 1)),
        off_row_perm=i32(rp),
        off_rows_s=i32(ta(off_rows, rp, 1)),
        off_cols_rp=i32(ta(off_cols, rp, 1)),
        a_row_d_s=i32(ta(a_row_d, rd, 1)),
        a_val_d_s=f(ta(a_val_d, rd, 1)),
        a_con_d_s=i32(ta(a_con_d, rd, 1)),
        off_col_perm=i32(cp),
        off_cols_sp=i32(ta(off_cols, cp, 1)),
        off_rows_cp=i32(ta(off_rows, cp, 1)),
        c_off_cp=f(ta(c_off, cp, 1)),
        a_pos_o_co_s=i32(ta(a_pos_o_co, pco, 1)),
        a_con_o_co_s=i32(ta(a_con_o, pco, 1)),
        a_val_o_co_s=f(ta(a_val_o, pco, 1)),
        off_rows_sorted=_rows_sorted(off_rows),
        off_cols_sorted=_rows_sorted(off_cols),
        a_con_d_sorted=_rows_sorted(a_con_d),
        a_con_o_sorted=_rows_sorted(a_con_o),
        # segment boundaries for every scatter-free path, built at ALL
        # dtypes since round 5: the compensated pair scan
        # (COMP_CUMSUM) serves f32 sums at scatter-grade accuracy too
        bnd_a_con_d=(_bounds_np(a_con_d, bp.m_loc)
                     if _rows_sorted(a_con_d) else None),
        bnd_a_con_o=(_bounds_np(a_con_o, bp.m_loc)
                     if _rows_sorted(a_con_o) else None),
        a_con_d_single=(_rows_sorted(a_con_d)
                        and _single_ids(a_con_d)),
        a_con_o_single=(_rows_sorted(a_con_o)
                        and _single_ids(a_con_o)),
        bnd_a_row_d_s=_bounds_np(ta(a_row_d, rd, 1), n),
        bnd_a_pos_o_s=_bounds_np(ta(a_pos_o, po, 1), Ko),
        bnd_a_pos_o_co_s=_bounds_np(ta(a_pos_o_co, pco, 1), Ko),
        # built at every dtype: cmul's f32 cumsum path needs them too
        # (they are only [B, n+1] ints)
        bnd_off_rows=(_bounds_np(off_rows, n)
                      if _rows_sorted(off_rows) else None),
        bnd_off_rows_s=_bounds_np(ta(off_rows, rp, 1), n),
        bnd_off_cols_sp=_bounds_np(ta(off_cols, cp, 1), n),
    )


def build_bucket_data(bp: BucketPlan, m_glob: int, dtype,
                      split: bool = True,
                      summed: bool = False) -> BucketData:
    """Convert a host BucketPlan into device arrays.

    ``summed``: the B axis is a shard axis of ONE logical cone
    (pattern sharding) — see BucketData.summed.  Sparse mode only.
    """
    B, n, K = bp.B, bp.n, bp.K
    assert not (summed and bp.dense), "summed buckets are sparse-mode"
    f = lambda x: jnp.asarray(x, dtype=dtype)
    i32 = lambda x: jnp.asarray(x, dtype=jnp.int32)
    sort_flags = dict(
        a_con_sorted=_rows_sorted(bp.a_con_loc),
        a_pos_sorted=_rows_sorted(bp.a_pos),
        pat_rows_sorted=_rows_sorted(bp.pat_rows),
        pat_cols_sorted=_rows_sorted(bp.pat_cols),
        glob_sorted=(B == 1) and _rows_sorted(bp.glob_idx),
        glob_ident=(B == 1 and not summed and bp.m_loc == m_glob
                    and bool(np.array_equal(bp.glob_idx[0],
                                            np.arange(m_glob)))),
    )
    # a_lin2's bounds stay f64-gated (n^2-sized; only the dense-mode
    # f64 fallback reads them); every other boundary array is built at
    # ALL dtypes since round 5 — the compensated pair scan
    # (COMP_CUMSUM) serves f32 segment sums too
    want_bounds = np.dtype(dtype) == np.float64
    a_con_single = (sort_flags["a_con_sorted"]
                    and _single_ids(bp.a_con_loc))
    common_bounds = dict(
        bnd_a_con=(_bounds_np(bp.a_con_loc, bp.m_loc)
                   if sort_flags["a_con_sorted"] else None),
        a_con_single=a_con_single,
        bnd_glob=(_bounds_np(bp.glob_idx, m_glob + 1)
                  if sort_flags["glob_sorted"] else None),
    )
    # static permutations making the remaining scatters sorted
    pperm = np.argsort(bp.a_pos, axis=1, kind="stable")
    rperm = np.argsort(bp.pat_rows, axis=1, kind="stable")
    perms = dict(
        a_pos_s=jnp.asarray(np.take_along_axis(bp.a_pos, pperm, 1),
                            jnp.int32),
        a_con_loc_s=jnp.asarray(
            np.take_along_axis(bp.a_con_loc, pperm, 1), jnp.int32),
        a_val_s=f(np.take_along_axis(bp.a_val, pperm, 1)),
        row_perm=jnp.asarray(rperm, jnp.int32),
        pat_rows_s=jnp.asarray(np.take_along_axis(bp.pat_rows, rperm, 1),
                               jnp.int32),
        pat_cols_rp=jnp.asarray(np.take_along_axis(bp.pat_cols, rperm, 1),
                                jnp.int32),
    )

    is_diag = (bp.pat_rows == bp.pat_cols)
    a_is_diag = np.take_along_axis(is_diag, bp.a_pos, axis=1)
    a_val_inner = bp.a_val * np.where(a_is_diag, 1.0, 2.0)
    c_pat_inner = bp.c_pat * np.where(is_diag, 1.0, 2.0)

    if bp.dense:
        rows = bp.pat_rows.astype(np.int64)
        cols = bp.pat_cols.astype(np.int64)
        a_rows = np.take_along_axis(rows, bp.a_pos.astype(np.int64), axis=1)
        a_cols = np.take_along_axis(cols, bp.a_pos.astype(np.int64), axis=1)
        a_lin = a_rows * n + a_cols
        a_lin_t = a_cols * n + a_rows
        a_val_mirror = np.where(a_rows == a_cols, 0.0, bp.a_val)
        c_full = np.zeros((B, n, n))
        bidx = np.repeat(np.arange(B), K)
        np.add.at(c_full, (bidx, bp.pat_rows.ravel(), bp.pat_cols.ravel()),
                  bp.c_pat.ravel())
        np.add.at(c_full, (bidx, bp.pat_cols.ravel(), bp.pat_rows.ravel()),
                  np.where(is_diag, 0.0, bp.c_pat).ravel())
        z1 = np.zeros((B, 1))
        zi = np.zeros((B, 1), dtype=np.int32)
        # statically sorted copy of the concat(a_lin, a_lin_t) scatter
        lin2 = np.concatenate([a_lin, a_lin_t], axis=1)
        lin2_perm = np.argsort(lin2, axis=1, kind="stable")
        lin2_s = np.take_along_axis(lin2, lin2_perm, axis=1)
        # exactness of the two-plane f32 W scatter: at most one
        # (statically) nonzero entry per slot in every block
        lin2_exact = True
        for b in range(B):
            keep = np.concatenate([bp.a_val[b] != 0.0,
                                   a_val_mirror[b] != 0.0])
            ids_nz = lin2[b][keep]
            lin2_exact &= bool(np.unique(ids_nz).size == ids_nz.size)

        # dense A^*(A(.)) fusion detection: every (real) constraint is
        # either diag-only or a single entry (see a_single_dense)
        single_ok = True
        a2_full = np.zeros((B, n, n))
        dd = []
        for b in range(B):
            real = bp.a_val[b] != 0.0
            con = bp.a_con_loc[b][real]
            r_ = a_rows[b][real]
            c_ = a_cols[b][real]
            v_ = bp.a_val[b][real]
            is_d = r_ == c_
            # per-constraint: all-diag or single-entry
            all_diag = np.ones(bp.m_loc, bool)
            np.logical_and.at(all_diag, con, is_d)
            cnts = np.bincount(con, minlength=bp.m_loc)
            single_ok &= bool(np.all(all_diag[con] | (cnts[con] == 1)))
            dsel = all_diag[con]
            dd.append((con[dsel], r_[dsel], v_[dsel]))
            osel = ~dsel
            w2 = np.where(r_[osel] == c_[osel], 1.0, 2.0) * v_[osel] ** 2
            np.add.at(a2_full[b], (r_[osel], c_[osel]), w2)
            np.add.at(a2_full[b], (c_[osel], r_[osel]),
                      np.where(r_[osel] == c_[osel], 0.0, w2))
        nnz_dd = max((d[0].size for d in dd), default=0)
        L_dd = max(nnz_dd, 1)
        dd_con = np.zeros((B, L_dd), np.int32)
        dd_row = np.zeros((B, L_dd), np.int32)
        dd_val = np.zeros((B, L_dd))
        for b, (dc, dr, dv) in enumerate(dd):
            dd_con[b, :dc.size] = dc
            dd_row[b, :dc.size] = dr
            dd_val[b, :dc.size] = dv
        single_fields = dict(a_single_dense=bool(single_ok),
                             nnz_dd=nnz_dd)
        if single_ok:
            single_fields.update(
                a2_full=f(a2_full), dd_con=i32(dd_con),
                dd_row=i32(dd_row), dd_val=f(dd_val))
        return BucketData(
            dense=True, n=n, K=K, nnz_a=bp.nnz_a, m_loc=bp.m_loc, B=B,
            m_glob=m_glob,
            a_con_loc=i32(bp.a_con_loc), a_val_inner=f(a_val_inner),
            glob_idx=i32(bp.glob_idx),
            pat_rows=i32(zi), pat_cols=i32(zi), c_pat=f(z1),
            c_pat_inner=f(z1), pat_offdiag=f(z1), a_pos=i32(zi),
            a_lin=i32(a_lin), a_lin_t=i32(a_lin_t), a_val=f(bp.a_val),
            a_val_mirror=f(a_val_mirror), c_full=f(c_full),
            a_lin2_perm=(i32(lin2_perm) if want_bounds else None),
            bnd_a_lin2=(_bounds_np(lin2_s, n * n)
                        if want_bounds else None),
            a_lin2_exact=lin2_exact,
            **single_fields, **perms, **sort_flags, **common_bounds,
        )
    z1 = np.zeros((B, 1))
    zi = np.zeros((B, 1), dtype=np.int32)
    if split:
        # the split arrays replace the union-pattern layout on device;
        # keep only placeholders for the union fields (the sharded
        # builders construct their own non-split BucketData)
        split_fields = _build_split_fields(bp, dtype,
                                           want_sym=summed)
        return BucketData(
            dense=False, n=n, K=K, nnz_a=bp.nnz_a, m_loc=bp.m_loc, B=B,
            m_glob=m_glob,
            a_con_loc=i32(zi), a_val_inner=f(z1),
            glob_idx=i32(bp.glob_idx),
            pat_rows=i32(zi), pat_cols=i32(zi), c_pat=f(z1),
            c_pat_inner=f(z1), pat_offdiag=f(z1), a_pos=i32(zi),
            a_lin=i32(zi), a_lin_t=i32(zi), a_val=f(z1),
            a_val_mirror=f(z1), c_full=f(np.zeros((B, 1, 1))),
            a_pos_s=i32(zi), a_con_loc_s=i32(zi), a_val_s=f(z1),
            row_perm=i32(zi), pat_rows_s=i32(zi), pat_cols_rp=i32(zi),
            summed=summed,
            **sort_flags, **common_bounds, **split_fields,
        )
    return BucketData(
        dense=False, n=n, K=K, nnz_a=bp.nnz_a, m_loc=bp.m_loc, B=B,
        m_glob=m_glob,
        a_con_loc=i32(bp.a_con_loc), a_val_inner=f(a_val_inner),
        glob_idx=i32(bp.glob_idx),
        pat_rows=i32(bp.pat_rows), pat_cols=i32(bp.pat_cols),
        c_pat=f(bp.c_pat), c_pat_inner=f(c_pat_inner),
        pat_offdiag=f(np.where(is_diag, 0.0, 1.0)), a_pos=i32(bp.a_pos),
        a_lin=i32(zi), a_lin_t=i32(zi), a_val=f(bp.a_val),
        a_val_mirror=f(z1), c_full=f(np.zeros((B, 1, 1))),
        bnd_a_pos_s=_bounds_np(
            np.take_along_axis(bp.a_pos, pperm, 1), K),
        bnd_pat_rows_s=_bounds_np(
            np.take_along_axis(bp.pat_rows, rperm, 1), n),
        bnd_pat_cols=(_bounds_np(bp.pat_cols, n)
                      if sort_flags["pat_cols_sorted"] else None),
        summed=summed,
        **perms, **sort_flags, **common_bounds,
    )


def cast_floats(tree, dtype=jnp.float32):
    """Cast every floating leaf of a pytree (e.g. a BucketData) to
    ``dtype``, leaving index/int arrays untouched.  Used by the
    mixed-precision paths (f32 Lanczos certificate sweeps, the ADMM
    iterative-refinement CG) to derive a low-precision view of the
    problem data on device; XLA dead-code-eliminates casts of leaves
    the consuming kernel never reads."""
    return jax.tree.map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        and x.dtype != dtype else x, tree)


# ---------------------------------------------------------------------------
# Kernels.  All take the bucket's factor matrices U, V: [B, n, r]
# ([1, n, r] replicated for summed buckets).
# ---------------------------------------------------------------------------

def _expand(bk: BucketData, X: jnp.ndarray) -> jnp.ndarray:
    """Broadcast a replicated factor-side array to the shard axis.

    For mesh-placed summed buckets the input is PINNED replicated
    first: without the pin GSPMD reshards the ALM loop-carry factors
    row-wise and re-gathers them at every kernel entry (about ten
    factor-sized collectives per inner iteration at D=2, the same
    disease DESIGN.md #21 documents for tp)."""
    if bk.summed and X.shape[0] != bk.B:
        return jnp.broadcast_to(_pin(bk, X), (bk.B,) + X.shape[1:])
    return X


def _reduce(bk: BucketData, X: jnp.ndarray) -> jnp.ndarray:
    """Sum a factor-shaped per-shard result back to [1, ...]
    (a psum over the mesh once the B axis is device-sharded); the
    result is pinned replicated (see _expand)."""
    if bk.summed:
        return _pin(bk, jnp.sum(X, axis=0, keepdims=True))
    return X


def _pin(bk: BucketData, x, *spec):
    """Pin an intermediate's sharding on the bucket's mesh (no-op for
    unsharded buckets).  ``spec`` are PartitionSpec axes: _pin(bk, x)
    pins replicated; _pin(bk, x, "blk") pins the leading axis to the
    mesh.  See BucketData.mesh for why the pins exist."""
    if bk.mesh is None:
        return x
    from jax.sharding import NamedSharding, PartitionSpec
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(bk.mesh, PartitionSpec(*spec)))


def _slab(bk: BucketData, X: jnp.ndarray) -> jnp.ndarray:
    """Row slabs of a replicated [1, n, r] factor -> [D, n_loc, r].
    Under mesh placement each device takes only its own slice."""
    r = X.shape[-1]
    n_pad = bk.B * bk.n_loc
    return jnp.pad(X[0], ((0, n_pad - bk.n), (0, 0))).reshape(
        bk.B, bk.n_loc, r)


def _unslab(bk: BucketData, X: jnp.ndarray) -> jnp.ndarray:
    """Concatenate disjoint row slabs [D, n_loc, r] -> [1, n, r]
    (an all_gather under mesh placement)."""
    return X.reshape(1, bk.B * bk.n_loc, X.shape[-1])[:, : bk.n]


def cone_total(bk: BucketData, vals: jnp.ndarray) -> jnp.ndarray:
    """Per-cone constraint values from per-shard partials: for summed
    and rowshard buckets the logical cone's A_j(UV^T) is the sum over
    shards (broadcast back so every shard sees the total)."""
    if bk.summed or bk.rowshard:
        return jnp.broadcast_to(
            jnp.sum(vals, axis=0, keepdims=True), vals.shape)
    return vals


def uvt(bk: BucketData, U: jnp.ndarray, V: jnp.ndarray):
    """sym(UV^T) = (UV^T + VU^T)/2, full (dense) or on-pattern (sparse).

    Sparse split mode returns a (diag [B, n], off [B, Ko]) pair — the
    diagonal costs only a dense rowsum.
    Reference: LORADSUVt (lorads_alg_common.c:21-68).
    """
    if bk.rowshard:
        # row slab of sym(UV^T): 0.5 (U_loc V^T + V_loc U^T), the
        # row-sharded dsyr2k — each shard computes [n_loc, n] as a
        # matrix product of its factor slab and the replicated side
        hi = jax.lax.Precision.HIGHEST
        U, V = _pin(bk, U), _pin(bk, V)     # factors replicated
        Us, Vs = _pin(bk, _slab(bk, U), "blk"), _pin(bk, _slab(bk, V),
                                                     "blk")
        return _pin(bk, 0.5 * (
            jnp.einsum("dkr,nr->dkn", Us, V[0],
                       preferred_element_type=U.dtype, precision=hi)
            + jnp.einsum("dkr,nr->dkn", Vs, U[0],
                         preferred_element_type=U.dtype, precision=hi)),
            "blk")
    U, V = _expand(bk, U), _expand(bk, V)
    if bk.dense:
        # HIGHEST: full f32 products (the GPU default for f32 is TF32,
        # ~1e-3 relative — too loose for the line search and CG)
        UVt = jnp.einsum("bnr,bmr->bnm", U, V,
                         preferred_element_type=U.dtype,
                         precision=jax.lax.Precision.HIGHEST)
        return 0.5 * (UVt + jnp.swapaxes(UVt, 1, 2))
    if bk.split:
        d = jnp.sum(U * V, -1)
        ur = take_rows(U, bk.off_rows)
        vc = take_rows(V, bk.off_cols)
        uc = take_rows(U, bk.off_cols)
        vr = take_rows(V, bk.off_rows)
        o = 0.5 * (jnp.sum(ur * vc, -1) + jnp.sum(uc * vr, -1))
        return d, o
    ur = take_rows(U, bk.pat_rows)
    vc = take_rows(V, bk.pat_cols)
    uc = take_rows(U, bk.pat_cols)
    vr = take_rows(V, bk.pat_rows)
    return 0.5 * (jnp.sum(ur * vc, -1) + jnp.sum(uc * vr, -1))


def uvt_pair(bk: BucketData, R: jnp.ndarray, D: jnp.ndarray):
    """(sym(RD^T), sym(DD^T)) pattern values sharing the row/col
    gathers of R and D (4 gathers instead of 6 per bucket).

    Used by the ALM line-search pair evaluation (ALMCalq12p12,
    lorads_alm.c:540-560).
    """
    R, D = _expand(bk, R), _expand(bk, D)
    if bk.dense:
        return uvt(bk, R, D), uvt(bk, D, D)
    if bk.split:
        rd_d = jnp.sum(R * D, -1)
        dd_d = jnp.sum(D * D, -1)
        Rr = take_rows(R, bk.off_rows)
        Rc = take_rows(R, bk.off_cols)
        Dr = take_rows(D, bk.off_rows)
        Dc = take_rows(D, bk.off_cols)
        rd_o = 0.5 * (jnp.sum(Rr * Dc, -1) + jnp.sum(Rc * Dr, -1))
        dd_o = jnp.sum(Dr * Dc, -1)
        return (rd_d, rd_o), (dd_d, dd_o)
    Rr = take_rows(R, bk.pat_rows)
    Rc = take_rows(R, bk.pat_cols)
    Dr = take_rows(D, bk.pat_rows)
    Dc = take_rows(D, bk.pat_cols)
    uv_rd = 0.5 * (jnp.sum(Rr * Dc, -1) + jnp.sum(Rc * Dr, -1))
    uv_dd = jnp.sum(Dr * Dc, -1)
    return uv_rd, uv_dd


def _at_entries(bk: BucketData, uvt_val: jnp.ndarray) -> jnp.ndarray:
    """Pattern values of sym(UV^T) at the constraint entries [B, nnz_a]."""
    if bk.rowshard:
        flat = uvt_val.reshape(uvt_val.shape[0], bk.n_loc * bk.n)
        return jnp.take_along_axis(flat, bk.a_lin, axis=1)
    if bk.dense:
        flat = uvt_val.reshape(uvt_val.shape[0], bk.n * bk.n)
        return jnp.take_along_axis(flat, bk.a_lin, axis=1)
    return jnp.take_along_axis(uvt_val, bk.a_pos, axis=1)


def constr_vals(bk: BucketData, uvt_val) -> jnp.ndarray:
    """A(sym(UV^T)) for all local constraints -> [B, m_loc].

    Reference: coneAUV / mul_inner_rk_double with the diagonal
    double-count correction (lorads_sdp_data.c:524-587, 698-715).
    """
    if bk.dense or not bk.split:
        contrib = bk.a_val_inner * _at_entries(bk, uvt_val)
        return batched_segment_sum(contrib, bk.a_con_loc, bk.m_loc,
                                   sorted_ids=bk.a_con_sorted,
                                   bounds=bk.bnd_a_con,
                                   single=bk.a_con_single,
                                   shard_batch=bk.mesh is not None)
    d, o = uvt_val
    if bk.diag_ident:
        vals = bk.a_val_d * d            # constraint i == diag entry i
    elif bk.has_diag_a:
        dg = jnp.take_along_axis(d, bk.a_row_d, axis=1) * bk.a_val_d
        vals = batched_segment_sum(dg, bk.a_con_d, bk.m_loc,
                                   sorted_ids=bk.a_con_d_sorted,
                                   bounds=bk.bnd_a_con_d,
                                   single=bk.a_con_d_single,
                                   shard_batch=bk.mesh is not None)
    else:
        vals = jnp.zeros((d.shape[0], bk.m_loc), dtype=d.dtype)
    if bk.has_off_a:
        og = jnp.take_along_axis(o, bk.a_pos_o, axis=1) * (
            2.0 * bk.a_val_o)
        vals = vals + batched_segment_sum(og, bk.a_con_o, bk.m_loc,
                                          sorted_ids=bk.a_con_o_sorted,
                                          shard_batch=bk.mesh is not None,
                                          bounds=bk.bnd_a_con_o,
                                          single=bk.a_con_o_single)
    return vals


def obj_inner(bk: BucketData, uvt_val) -> jnp.ndarray:
    """<C, sym(UV^T)> per block -> [B].  Reference: objAUV."""
    if bk.dense:
        return jnp.sum(bk.c_full * uvt_val, axis=(1, 2))
    if bk.split:
        d, o = uvt_val
        out = jnp.sum(bk.c_diag * d, axis=1)
        if bk.has_off:
            out = out + jnp.sum(bk.c_off2 * o, axis=1)
        return out
    return jnp.sum(bk.c_pat_inner * uvt_val, axis=1)


def scatter_constr(bk: BucketData, vals: jnp.ndarray) -> jnp.ndarray:
    """Scatter local constraint values into the global m-vector.

    Reference: lorads_vec add / the sparse-cone rowIdx reposition
    (lorads_elements.c:7-37, lorads_admm.c:360-372).
    """
    if bk.glob_ident:
        return vals[0]
    if _use_bounds(vals, bk.bnd_glob):
        out = (comp_segment_sum(vals, bk.bnd_glob) if COMP_CUMSUM
               else bounded_segment_sum(vals, bk.bnd_glob))
        return _pin(bk, jnp.sum(out, axis=0)[: bk.m_glob])
    flat = jax.ops.segment_sum(vals.reshape(-1), bk.glob_idx.reshape(-1),
                               num_segments=bk.m_glob + 1,
                               indices_are_sorted=bk.glob_sorted)
    return _pin(bk, flat[: bk.m_glob])


def gather_w(bk: BucketData, w: jnp.ndarray) -> jnp.ndarray:
    """Gather a global m-vector at this bucket's constraint slots."""
    if bk.glob_ident:
        return w[None]
    w1 = jnp.concatenate([w, jnp.zeros((1,), dtype=w.dtype)])
    return w1[bk.glob_idx]


def build_w(bk: BucketData, w_loc: jnp.ndarray,
            include_obj: bool = True) -> jnp.ndarray:
    """W = [C +] sum_i w_i A_i (as pattern values or full matrices).

    Reference: addObjCoeff + sdpDataWSum (lorads_sdp_conic.c:327-339,
    437-445, 633-641).  ``include_obj=False`` gives the pure adjoint
    A^*(w) used inside the ADMM CG operator (lorads_admm.c:383-385).
    """
    if bk.rowshard:
        # full-symmetric entries owned by this row slab: one sorted
        # scatter into the [n_loc, n] slab (no mirror pass — mirrors
        # are in the entry list, each on the shard owning its row).
        # clip: pad entries carry con id m_loc (keeps ids sorted) and
        # value 0, so the clamped gather contributes nothing
        wa = jnp.take_along_axis(w_loc, bk.a_con_loc_s, axis=1,
                                 mode="clip")
        val = bk.a_val_s * wa
        nn = bk.n_loc * bk.n
        sb = bk.mesh is not None
        if (CUMSUM_F64 and val.dtype == jnp.float64
                and bk.a_lin2_exact):
            # slot-unique entries: the f64 scatter runs as two EXACT
            # f32 planes (split_f64, error <= 2^-47)
            hi, lo = split_f64(val)
            W = (batched_segment_sum(hi, bk.a_pos_s, nn, sorted_ids=True,
                                     shard_batch=sb).astype(val.dtype)
                 + batched_segment_sum(lo, bk.a_pos_s, nn,
                                       sorted_ids=True,
                                       shard_batch=sb).astype(val.dtype))
        else:
            W = batched_segment_sum(val, bk.a_pos_s, nn,
                                    sorted_ids=True, shard_batch=sb)
        W = _pin(bk, W.reshape(-1, bk.n_loc, bk.n), "blk")
        return bk.c_full + W if include_obj else W
    if bk.dense:
        wa = jnp.take_along_axis(w_loc, bk.a_con_loc, axis=1)
        n2 = bk.n * bk.n
        val = jnp.concatenate([bk.a_val * wa, bk.a_val_mirror * wa], axis=1)
        pos = jnp.concatenate([bk.a_lin, bk.a_lin_t], axis=1)
        if (CUMSUM_F64 and val.dtype == jnp.float64 and bk.a_lin2_exact):
            # each slot receives at most one nonzero entry, so the f64
            # scatter can run as two EXACT f32 planes (split_f64);
            # placement is exact, recombination error <= 2^-47 |v|
            hi, lo = split_f64(val)
            W = (batched_segment_sum(hi, pos, n2).astype(val.dtype)
                 + batched_segment_sum(lo, pos, n2).astype(val.dtype))
            W = W.reshape(-1, bk.n, bk.n)
        elif _use_bounds(val, bk.bnd_a_lin2):
            # statically sorted copy of the concat scatter: one gather
            # at the static perm + the scatter-free bounded sum
            val_s = jnp.take_along_axis(val, bk.a_lin2_perm, axis=1)
            W = (comp_segment_sum(val_s, bk.bnd_a_lin2) if COMP_CUMSUM
                 else bounded_segment_sum(val_s, bk.bnd_a_lin2))
            W = W.reshape(-1, bk.n, bk.n)
        else:
            W = batched_segment_sum(val, pos, n2).reshape(-1, bk.n, bk.n)
        return bk.c_full + W if include_obj else W
    if bk.split:
        if bk.diag_ident:
            W_d = bk.a_val_d * w_loc     # row i == constraint i
        elif bk.has_diag_a:
            wa_d = jnp.take_along_axis(w_loc, bk.a_con_d_s, axis=1)
            W_d = batched_segment_sum(bk.a_val_d_s * wa_d, bk.a_row_d_s,
                                      bk.n, sorted_ids=True,
                                      bounds=bk.bnd_a_row_d_s,
                                      shard_batch=bk.mesh is not None)
        else:
            W_d = jnp.zeros((w_loc.shape[0], bk.n), dtype=w_loc.dtype)
        if bk.has_off_a:
            wa_o = jnp.take_along_axis(w_loc, bk.a_con_o_s, axis=1)
            W_o = batched_segment_sum(bk.a_val_o_s * wa_o, bk.a_pos_o_s,
                                      bk.Ko, sorted_ids=True,
                                      bounds=bk.bnd_a_pos_o_s,
                                      shard_batch=bk.mesh is not None)
            # col-order copy via statically remapped entry indices —
            # a second small sorted scatter, not a runtime permutation
            wa_oc = jnp.take_along_axis(w_loc, bk.a_con_o_co_s, axis=1)
            W_oc = batched_segment_sum(
                bk.a_val_o_co_s * wa_oc, bk.a_pos_o_co_s, bk.Ko,
                sorted_ids=True, bounds=bk.bnd_a_pos_o_co_s,
                shard_batch=bk.mesh is not None)
        else:
            W_o = jnp.zeros((w_loc.shape[0], bk.Ko), dtype=w_loc.dtype)
            W_oc = W_o
        if include_obj:
            return bk.c_diag + W_d, bk.c_off + W_o, bk.c_off_cp + W_oc
        return W_d, W_o, W_oc
    # entries pre-permuted to pattern-slot order: the scatter is sorted
    wa_s = jnp.take_along_axis(w_loc, bk.a_con_loc_s, axis=1)
    W = batched_segment_sum(bk.a_val_s * wa_s, bk.a_pos_s, bk.K,
                            sorted_ids=True, bounds=bk.bnd_a_pos_s)
    return bk.c_pat + W if include_obj else W


def w_mul(bk: BucketData, W, X: jnp.ndarray) -> jnp.ndarray:
    """W @ X for symmetric W given as build_w output -> [B, n, r].

    Reference: mul_rk (lorads_sdp_data.c:491-504, 646-671).
    """
    if bk.rowshard:
        # row-sharded dsymm: disjoint grad row slabs, concatenated
        # back to the replicated [1, n, r] (all_gather over the mesh)
        X = _pin(bk, X)
        out = jnp.einsum("dkn,nr->dkr", _pin(bk, W, "blk"), X[0],
                         preferred_element_type=X.dtype,
                         precision=jax.lax.Precision.HIGHEST)
        return _pin(bk, _unslab(bk, out))
    X = _expand(bk, X)
    if bk.dense:
        return jnp.einsum("bnm,bmr->bnr", W, X,
                          preferred_element_type=X.dtype,
                          precision=jax.lax.Precision.HIGHEST)
    if bk.split:
        W_d, W_o, W_oc = W
        out = W_d[:, :, None] * X
        if bk.has_off:
            # lower pass in row-sorted order (a [Ko] gather of W_o buys
            # a sorted scatter); upper pass rides the col-order mirror
            W_rp = jnp.take_along_axis(W_o, bk.off_row_perm, axis=1)
            xc_rp = take_rows(X, bk.off_cols_rp)
            out = out + batched_segment_sum(
                W_rp[:, :, None] * xc_rp, bk.off_rows_s, bk.n,
                sorted_ids=True, bounds=bk.bnd_off_rows_s,
                shard_batch=bk.mesh is not None)
            xr_cp = take_rows(X, bk.off_rows_cp)
            out = out + batched_segment_sum(
                W_oc[:, :, None] * xr_cp, bk.off_cols_sp, bk.n,
                sorted_ids=True, bounds=bk.bnd_off_cols_sp,
                shard_batch=bk.mesh is not None)
        return _reduce(bk, out)
    # lower pass in row-sorted order (one extra [K] gather of W buys
    # a sorted scatter); upper pass is already column-sorted
    W_rp = jnp.take_along_axis(W, bk.row_perm, axis=1)
    xc_rp = take_rows(X, bk.pat_cols_rp)
    lower = batched_segment_sum(W_rp[:, :, None] * xc_rp, bk.pat_rows_s,
                                bk.n, sorted_ids=True,
                                bounds=bk.bnd_pat_rows_s)
    xr = take_rows(X, bk.pat_rows)
    upper = batched_segment_sum(
        (W * bk.pat_offdiag)[:, :, None] * xr, bk.pat_cols, bk.n,
        sorted_ids=bk.pat_cols_sorted, bounds=bk.bnd_pat_cols)
    return _reduce(bk, lower + upper)


def densify_w(bk: BucketData, W) -> jnp.ndarray:
    """Materialize a sparse-mode ``build_w`` output as full symmetric
    [B, n, n] matrices.

    Certificate-time only (see solver._dual_infeas_device): small
    sparse slack blocks get an exact eigh instead of the Lanczos sweep,
    extending the round-1 dense-only rescue to sparse-mode cones.
    Never used in the iteration hot path.
    """
    if bk.dense or bk.rowshard:
        raise ValueError("densify_w is for sparse-mode buckets")
    scat = jax.vmap(lambda o, r, c, w: o.at[r, c].add(w))
    if bk.split:
        W_d, W_o, _ = W
        out = jax.vmap(jnp.diag)(W_d)
        if bk.has_off:
            # pad slots carry zero values, so their scatter adds nothing
            out = scat(out, bk.off_rows, bk.off_cols, W_o)
            out = scat(out, bk.off_cols, bk.off_rows, W_o)
        return out
    out = jnp.zeros((W.shape[0], bk.n, bk.n), W.dtype)
    out = scat(out, bk.pat_rows, bk.pat_cols, W)
    # mirror only the strict off-diagonal (pat_offdiag = 1 iff r != c)
    out = scat(out, bk.pat_cols, bk.pat_rows, W * bk.pat_offdiag)
    return out


def auv_into_global(bk: BucketData, U: jnp.ndarray, V: jnp.ndarray):
    """Convenience: (local constraint values, global scatter)."""
    vals = constr_vals(bk, uvt(bk, U, V))
    return vals, scatter_constr(bk, vals)


# ---------------------------------------------------------------------------
# Incremental pattern caches.
#
# The ALM/CG iterates evolve by axpys (R += tau * D), so the gathered
# off-pattern rows evolve the same way: cache (X[off_rows], X[off_cols])
# once and update it with tau * (D[off_rows], D[off_cols]) — the per-
# iteration gathers then touch only the new direction.  Exact in exact
# arithmetic; refreshed on the same cadence as the incremental
# constraint sums (alm.py refresh_every).
# ---------------------------------------------------------------------------

def gather_cache(bk: BucketData, X: jnp.ndarray):
    """(X[off_rows], X[off_cols], X[off_rows_cp]) for split buckets,
    else None.  The third entry is the col-order mirror consumed by
    w_mul_cached's sorted upper-half scatter."""
    if bk.dense or not bk.split or not bk.has_off:
        return None
    X = _expand(bk, X)
    return (take_rows(X, bk.off_rows), take_rows(X, bk.off_cols),
            take_rows(X, bk.off_rows_cp))


def uvt_from_cache(bk: BucketData, R: jnp.ndarray, cache):
    """sym(RR^T) pattern values from the cache (no gathers)."""
    if cache is None:
        return uvt(bk, R, R)
    Rr, Rc = cache[0], cache[1]
    return _expand(bk, jnp.sum(R * R, -1)), jnp.sum(Rr * Rc, -1)


def uvt_pair_cached(bk: BucketData, R: jnp.ndarray, D: jnp.ndarray,
                    cache):
    """uvt_pair using the R-cache; returns (pair, d_cache) where
    d_cache holds D's gathered rows for the caller's cache update."""
    if cache is None:
        return uvt_pair(bk, R, D), None
    Rr, Rc = cache[0], cache[1]
    De = _expand(bk, D)
    Dr = take_rows(De, bk.off_rows)
    Dc = take_rows(De, bk.off_cols)
    Dr_cp = take_rows(De, bk.off_rows_cp)
    rd_d = _expand(bk, jnp.sum(R * D, -1))
    dd_d = _expand(bk, jnp.sum(D * D, -1))
    rd_o = 0.5 * (jnp.sum(Rr * Dc, -1) + jnp.sum(Rc * Dr, -1))
    dd_o = jnp.sum(Dr * Dc, -1)
    return ((rd_d, rd_o), (dd_d, dd_o)), (Dr, Dc, Dr_cp)


def uvt_half_cached(bk: BucketData, X: jnp.ndarray, F: jnp.ndarray,
                    fcache):
    """sym(X F^T) pattern values with F's rows cached (ADMM CG: the
    fixed factor is constant across the whole CG solve)."""
    if fcache is None:
        return uvt(bk, X, F)
    Fr, Fc = fcache[0], fcache[1]
    Xe = _expand(bk, X)
    Xr = take_rows(Xe, bk.off_rows)
    Xc = take_rows(Xe, bk.off_cols)
    d = _expand(bk, jnp.sum(X * F, -1))
    o = 0.5 * (jnp.sum(Xr * Fc, -1) + jnp.sum(Xc * Fr, -1))
    return d, o


def a_adj_a_dense(bk: BucketData, X_full: jnp.ndarray) -> jnp.ndarray:
    """Fused W = A^*(A(X)) for dense-mode buckets with single-entry /
    diag-only constraints (bk.a_single_dense): the single-entry part
    is the STATIC elementwise plane a2_full .* X; diag-only
    constraints (theta's trace) compose through two small segment sums
    on the diagonal."""
    W = bk.a2_full * X_full
    if bk.nnz_dd:
        d = jnp.diagonal(X_full, axis1=1, axis2=2)          # [B, n]
        dg = jnp.take_along_axis(d, bk.dd_row, axis=1) * bk.dd_val
        vals = batched_segment_sum(dg, bk.dd_con, bk.m_loc)
        wv = jnp.take_along_axis(vals, bk.dd_con, axis=1) * bk.dd_val
        W_d = batched_segment_sum(wv, bk.dd_row, bk.n)
        B, n = W_d.shape
        W = W + W_d[:, :, None] * jnp.eye(n, dtype=W.dtype)[None]
    return W


def a_adj_a(bk: BucketData, uvt_val):
    """Fused W = A^*(A(sym(X))) for split buckets whose off constraint
    entries are slot-unique (bk.a_off_unique): each off constraint
    reads one pattern slot and its adjoint writes the same slot back,
    so the off part is a STATIC elementwise scale 2 a^2 — no
    constraint-space round trip.  Diag-entry constraints (e.g. theta's
    trace) compose generically through constraint space (they are
    disjoint from the off constraints by the a_off_unique gate).

    This is the ADMM CG operator's inner composition
    (linSysProduct, lorads_admm.c:376-391) exploiting structure the
    reference's per-cone loops cannot see.
    """
    d, o = uvt_val
    W_o = bk.a2_off * o
    W_oc = bk.a2_off_cp * jnp.take_along_axis(o, bk.off_col_perm, axis=1)
    if bk.has_diag_a:
        dg = jnp.take_along_axis(d, bk.a_row_d, axis=1) * bk.a_val_d
        vals = batched_segment_sum(dg, bk.a_con_d, bk.m_loc,
                                   sorted_ids=bk.a_con_d_sorted,
                                   bounds=bk.bnd_a_con_d,
                                   single=bk.a_con_d_single,
                                   shard_batch=bk.mesh is not None)
        wa_d = jnp.take_along_axis(vals, bk.a_con_d_s, axis=1)
        W_d = batched_segment_sum(bk.a_val_d_s * wa_d, bk.a_row_d_s,
                                  bk.n, sorted_ids=True,
                                  bounds=bk.bnd_a_row_d_s,
                                  shard_batch=bk.mesh is not None)
    else:
        W_d = jnp.zeros((d.shape[0], bk.n), dtype=d.dtype)
    return W_d, W_o, W_oc


def cmul(bk: BucketData, X: jnp.ndarray,
         include_diag: bool = True) -> jnp.ndarray:
    """C @ X for split-mode buckets (C is the STATIC objective block).

    The diag-identity ALM fast path keeps an incremental cache of
    CR = C @ R (advanced by tau * C @ D per line-search step), which
    makes the gradient 2 (C + A^*(w)) R purely elementwise when the
    adjoint is diagonal.  The two segment sums take the scatter-free
    cumsum route at f32 too (gradient-path accuracy, CUMSUM_F32_GRAD).
    Reference semantics: mul_rk with the objective matrix
    (lorads_sdp_data.c:491-504).
    """
    Xe = _expand(bk, X)
    out = bk.c_diag[:, :, None] * Xe if include_diag \
        else jnp.zeros_like(Xe)
    if bk.has_off:
        # single pass over the full-symmetric row-sorted entry list:
        # one gather + one segment sum over 2*Ko entries.  For very
        # large patterns the [B, Ks, r] gather/scan transients are
        # chunked over contiguous slices of the row-sorted list (each
        # slice's segment boundaries are the clipped global bounds;
        # partial segments compose exactly by addition) — bounds the
        # peak device memory at ~_CMUL_CHUNK * r * 4 bytes per
        # intermediate
        # instead of Ks * r (maxcut n=500000: Ks = 10M, VERDICT r4 #4)
        Ks = bk.sym_rows_rs.shape[1]
        step = _CMUL_CHUNK if Ks > 2 * _CMUL_CHUNK else Ks
        acc = None
        for s in range(0, Ks, step):
            e = min(s + step, Ks)
            Xs = take_rows(Xe, bk.sym_cols_rs[:, s:e])
            contrib = bk.c_sym_rs[:, s:e, None] * Xs
            if bk.bnd_sym_rows is not None and step != Ks:
                part = comp_segment_sum(
                    contrib, jnp.clip(bk.bnd_sym_rows - s, 0, e - s))
            else:
                part = batched_segment_sum(
                    contrib, bk.sym_rows_rs[:, s:e], bk.n,
                    sorted_ids=True, bounds=bk.bnd_sym_rows,
                    f32_bounds=True, shard_batch=bk.mesh is not None)
            acc = part if acc is None else acc + part
        out = out + acc
    return _reduce(bk, out)


def w_mul_cached(bk: BucketData, W, X: jnp.ndarray, cache) -> jnp.ndarray:
    """w_mul consuming the cache instead of gathering X's rows.

    Both scatters run at SORTED ids: the lower pass via off_rows
    (pattern order is row-sorted for every presolve-built pattern) and
    the upper pass via the col-order mirror (off_cols_sp + cache[2]),
    so neither pays random-access scatter latency."""
    if cache is None:
        return w_mul(bk, W, X)
    W_d, W_o, W_oc = W
    out = W_d[:, :, None] * _expand(bk, X)
    Xr, Xc, Xr_cp = cache
    out = out + batched_segment_sum(W_o[:, :, None] * Xc, bk.off_rows,
                                    bk.n, sorted_ids=bk.off_rows_sorted,
                                    bounds=bk.bnd_off_rows)
    out = out + batched_segment_sum(W_oc[:, :, None] * Xr_cp,
                                    bk.off_cols_sp, bk.n,
                                    sorted_ids=True,
                                    bounds=bk.bnd_off_cols_sp)
    return _reduce(bk, out)
