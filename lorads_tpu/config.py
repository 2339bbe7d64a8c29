"""Solver parameters and status codes.

Mirrors the reference flag system: `lorads_params` struct
(/root/reference/src_semi/lorads.h:82-105), defaults
(/root/reference/src_semi/main.c:19-43) and the getopt_long table
(/root/reference/src_semi/main.c:57-80).  `rho_celling_admm` is
force-recomputed as `rho_max * 200` after parsing (main.c:236) — we
reproduce that in `__post_init__`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class SolverStatus(enum.Enum):
    """Reference: lorads_status (/root/reference/src_semi/lorads.h:45-51)."""

    UNKNOWN = "unknown"
    PRIMAL_DUAL_OPTIMAL = "primal_dual_optimal"
    PRIMAL_OPTIMAL = "primal_optimal"
    MAXITER = "max_iter"
    TIME_LIMIT = "time_limit"


class RetCode(enum.Enum):
    """Reference: RET_CODE_* (/root/reference/src_semi/lorads.h:62-65)."""

    OK = 0
    TIME_OUT = 1
    NUM_ERR = 4
    BAD_ITER = 8


@dataclasses.dataclass
class LoradsParams:
    """All user-facing knobs, defaults per reference main.c:19-43."""

    fname: Optional[str] = None
    init_rho: float = 0.0            # 0 -> 1/sqrt(sum blkDims) (lorads_solver.c:1155-1164)
    rho_max: float = 5000.0
    rho_celling_alm: float = 1e8
    rho_celling_admm: float = 1e6    # recomputed = rho_max*200 (main.c:236)
    max_alm_iter: int = 200
    max_admm_iter: int = 10000
    # Reference default is 2.0 (main.c:28).  None -> auto per block:
    # 2.0 for dims <= 32768, 3.0 above — at large n the log-rank rule
    # undershoots and the solver pays two rank-augmentation restarts
    # (maxcut n=100000 starts at rank 24 and grows to 35; starting at
    # 35 skips both restarts).  These auto defaults were tuned by wall
    # clock on the previous accelerator and are due for re-measurement
    # on the GPU (ROADMAP).
    times_log_rank: Optional[float] = None
    rho_freq: int = 5
    rho_factor: float = 1.2
    # Reference default is 2.0 (main.c:30).  None -> auto: 3.0 when
    # every SDP block's constraints are pure diagonal identities and
    # there is no LP block (the Max-Cut shape, where ALM alone
    # certifies and the high-rho tail dominates, so a faster rho climb
    # shortens it), else the reference 2.0 (matcomp regressed at 3.0;
    # theta hands off to ADMM whose entry rho the ALM exit rho
    # shifts).
    alm_rho_factor: Optional[float] = None
    phase1_tol: float = 1e-3
    phase2_tol: float = 1e-5
    time_sec_limit: float = 3600.0
    heuristic_factor: float = 1.0
    # Reference default is 2 (main.c:31).  None -> auto: 3 for pure
    # sparse-pattern problems (the extra history costs only small
    # elementwise axpys while cutting inner iterations), and 4 when
    # any large dense-mode block is present: theta800 seed 5 grinds
    # 12198 inner iterations at L=2 vs 3052 at L=4, while the other
    # theta sizes and seeds barely move either way.
    lbfgs_list_length: Optional[int] = None
    end_tau_tol: float = 1e-16
    end_alm_sub_tol: float = 1e-10
    l2_rescaling: bool = False       # parsed but unused in solve path (reference parity)
    reopt_level: int = 2
    dyrank_level: int = 2
    high_acc_mode: bool = False

    # --- extensions (no reference counterpart) ---
    dtype: str = "auto"              # "f32" | "f64" | "auto":
                                     # auto = f64 on CPU; on an
                                     # accelerator start f32 and
                                     # escalate to f64 when the f32
                                     # noise floor blocks the target
                                     # tolerance (ROADMAP D2)
    seed: int = 925                  # reference srand(925) (lorads_solver.c:415)
    # Cap on ADMM iterations per device dispatch, i.e. how often the
    # host takes control back for the time limit and the log.  None ->
    # auto: 50 (the reference log cadence, lorads_admm.c:139) for large
    # problems, 200 for small ones where per-dispatch host overhead
    # dominates (log cadence coarsens accordingly).
    device_chunk_iters: Optional[int] = None
    verbose: bool = True
    dense_threshold: float = 0.1     # union density above which block goes dense
    per_matrix_dense_threshold: float = 0.1  # lorads_sdp_data.c:811-828
    dense_dim_threshold: int = 20    # dims below this always dense (conic.c:884)
    sparse_cone_threshold: float = 0.3   # lorads.h:13
    # Cap on devices used by --shard placement (solver._maybe_shard
    # meshes jax.devices()[:n_devices]).  None -> all local devices.
    n_devices: Optional[int] = None
    admm_jacobi: bool = False        # Jacobi within multi-block buckets
    # ADMM LP columns: the reference updates them SEQUENTIALLY, each
    # reading the constrValSum already updated by previous columns
    # (Gauss-Seidel; lorads_admm.c:595-628 via lorads_alg_common.c:
    # 229-247).  The default here sweeps them Jacobi with the
    # self-contribution removed analytically (DESIGN.md deviation #4)
    # — identical fixed points, near-identical trajectories on all
    # tested instances, fully vectorized.  True restores the exact
    # reference order via a lax.scan over columns (serial on device;
    # use on strongly coupled LP blocks that diverge under Jacobi).
    lp_gauss_seidel: bool = False
    # reference compile-time DUAL_U_V feature define (lorads_admm.c:483-591):
    # +/-S consensus terms in the ADMM subproblems; S stays at its
    # initial value exactly as the shipped reference never updates it
    dual_uv: bool = False
    # Dual certificate repair (extension, no reference counterpart):
    # when a block's constraint span contains its identity (theta's
    # trace constraint; Max-Cut's diagonal family), a negative slack
    # eigenvalue lam is removed EXACTLY by shifting the dual along
    # that direction (S - lam I is PSD), trading a |lam|-sized dObj
    # move for dinf ~ 0.  The shifted dual is a genuinely feasible
    # dual point, so every reported number stays honest (dinf is
    # re-measured after the shift).  Spares the expensive high-rho
    # ALM polish whose only purpose is driving dinf down.
    dual_repair: bool = True
    # Direct dual-feasibility restoration suite (extension; VERDICT r2
    # #2): when dinf fails its acceptance band after the initial
    # two-phase solve, try — in order, before conceding to the
    # reference-style reopt grind —
    # (a) SPECTRAL-BUNDLE REPAIR (solver._try_spectral_repair): shift
    #     the dual along the least-squares preimage of the slack's
    #     offending eigendirections, b-orthogonally (dObj/gap exactly
    #     preserved), re-certifying each round; every collected
    #     direction's Rayleigh quotient is affine in the dual, so the
    #     growing bundle re-evaluates for free;
    # (b) COMPLEMENTARITY CGNR (alg/dualrefine.py): b-orthogonal
    #     linear LS min ||(C - A^*(y)) R||_F on the spectrum-weighted
    #     factors — effective when the violation lives in range(R)
    #     (the spectral repair covers the orthogonal case).
    # Candidates are kept only when the re-measured certified outcome
    # improves; the reopt path remains as the fallback.  No-LP
    # problems only (a dual move changes LP column slacks).
    dual_refine: bool = True
    # Mixed-precision ADMM CG (deviation; VERDICT r2 #1): on
    # f64-escalated solves the CG sweeps run at f32 on an f32 cast of
    # the same operator with f64 residual accumulation / iterative
    # refinement (cg.cg_solve_ir) — the exit still tests the TRUE f64
    # residual against the reference rule (lorads_cgs.c:191-194), so
    # solution accuracy is unchanged while the f64 matvec runs once per
    # refinement pass instead of every CG iteration.  False = every CG
    # matvec at the ambient dtype (exact reference arithmetic).
    admm_mixed_cg: bool = True
    # ADMM gap continuation (deviation, documented in DESIGN.md): the
    # reference ADMM exits on pinf alone (lorads_admm.c:110-118) and
    # concedes gap > phase2Tol to a full reopt round (objective
    # rescale + high-rho ALM re-grind, main.c:376-398 — ~2x the whole
    # solve on theta).  With this on, the initial ADMM keeps running
    # with gap-inclusive convergence while the gap still improves
    # (device-side stall exit after 75 no-progress iterations), so a
    # solve whose gap is within reach never pays the reopt.
    admm_gap_continue: bool = True
    # multi-device placement: "off" | "auto" | "dp" | "sp" | "tp".
    # dp = block-axis data parallelism (bucket B axis over the mesh);
    # sp = union-pattern sharding for single large sparse cones
    # (summed BucketData, factors replicated, W.X partials psum'd);
    # tp = row-slab sharding for single large DENSE cones (rowshard
    # BucketData: every n x n intermediate lives as [D, n_loc, n]
    # slabs — distributed dsyr2k/dsymm, per-chip memory n^2/D);
    # auto = dp where the block axis divides the mesh, else sp/tp
    # where eligible.  GSPMD partitions the solver's jitted programs.
    shard: str = "off"
    fix_init_point: bool = False     # deterministic all-ones init
                                     # (FIX_INI_POINT, lorads_solver.c:441)
    checkpoint_path: Optional[str] = None  # save state at phase boundaries
    trace_dir: Optional[str] = None  # jax.profiler trace output dir

    def __post_init__(self):
        self.rho_celling_admm = self.rho_max * 200.0

    @property
    def rank_flag_thres(self) -> float:
        """Difficulty threshold triggering rank augmentation.

        Reference: lorads_alm.c:1022-1031 keyed on dyrankLevel.
        """
        return {0: 1e8, 1: 150.0, 2: 15.0, 3: 5.0}[self.dyrank_level]
