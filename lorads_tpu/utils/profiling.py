"""Timers, counters and device-trace hooks.

The reference tracks wall-clock only (gettimeofday wrappers,
/root/reference/src_semi/lorads_utils.c:52-58, plus per-phase
accumulators in main.c:314-317 and CG stats def_lorads_cgs.h:43-46).
This module carries the same counters and adds `jax.profiler` trace
sessions that capture XLA execution timelines on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional


@dataclasses.dataclass
class PhaseTimers:
    """Per-phase wall-clock accumulators (main.c:314-317 analogue)."""

    read: float = 0.0
    presolve: float = 0.0
    alm: float = 0.0
    admm: float = 0.0
    reopt: float = 0.0
    dual_infeas: float = 0.0
    total: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


class Stopwatch:
    """Accumulating context-manager timer."""

    def __init__(self):
        self.elapsed = 0.0

    @contextlib.contextmanager
    def __call__(self):
        t0 = time.time()
        try:
            yield
        finally:
            self.elapsed += time.time() - t0


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Capture an XLA device trace viewable in TensorBoard/XProf.

    No-op when logdir is None (the default), so production runs pay
    nothing.  Usage:

        with device_trace("/tmp/lorads_trace"):
            solver.solve()
    """
    if logdir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class CGStats:
    """Cumulative CG statistics (def_lorads_cgs.h:43-46 analogue)."""

    iters: int = 0
    solves: int = 0

    def add(self, iters: int, solves: int = 1):
        self.iters += int(iters)
        self.solves += solves


# ---------------------------------------------------------------------------
# Roofline accounting (VERDICT r1 #5; no reference counterpart — the
# reference reports wall-clock only).
#
# FLOPs/bytes come from XLA's own compiled cost model
# (compiled.cost_analysis()).  CAVEAT: 'bytes accessed' counts each
# op's logical operand/result traffic BEFORE fusion, so it is an UPPER
# bound on real HBM traffic — a memory-bound target computed from it
# is an upper bound on required time, and "wall below target" means
# fusion beat the unfused bound, not faster-than-light hardware.
# FLOPs are fusion-independent and exact.  Peaks below are per-chip
# DATASHEET numbers; MFU/BW% are fractions of those.
# ---------------------------------------------------------------------------

# Dense peak rates per device_kind, from NVIDIA's H100 data sheet
# (dense, no sparsity).  f64 and f32 run through the tensor cores'
# DGEMM path and the CUDA cores respectively; f32 here is the plain
# rate, not TF32, because the package forces HIGHEST matmul precision
# (lorads_tpu/__init__.py).  "hbm" is device-memory bandwidth in B/s.
_PEAKS = {
    # SXM5 part, 700 W
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12,
                              "f64": 67e12, "hbm": 3.35e12},
    # PCIe part, 350 W
    "NVIDIA H100 PCIe": {"bf16": 756e12, "f32": 51e12, "f64": 51e12,
                         "hbm": 2.0e12},
}


def chip_peaks(device=None) -> Dict[str, float]:
    """Data-sheet peaks for the current (or given) device.

    Raises ValueError for a device not in the table: a roofline
    against the wrong chip's peaks is worse than none."""
    import jax

    d = device or jax.devices()[0]
    kind = getattr(d, "device_kind", "")
    if kind not in _PEAKS:
        raise ValueError(f"no peak rates known for device kind {kind!r}"
                         f" (known: {sorted(_PEAKS)})")
    return _PEAKS[kind]


def compiled_cost(compiled) -> Dict[str, float]:
    """(flops, bytes) of one dispatch from XLA's compiled cost model."""
    ca = compiled.cost_analysis()
    if isinstance(ca, list):     # older jax returns [dict]
        ca = ca[0]
    return {"flops": float(ca.get("flops", 0.0)),
            "bytes": float(ca.get("bytes accessed", 0.0))}


def roofline(flops: float, bytes_: float, wall_s: float,
             dtype: str = "f32", device=None) -> Dict[str, float]:
    """Roofline summary for one measured dispatch (or iteration).

    target_s  — the speed-of-light time max(flops/peak, bytes/bw):
                below it the measurement is impossible, near it the
                kernel is compute- or bandwidth-bound, far above it
                the kernel is latency/occupancy-bound.
    mfu       — achieved fraction of peak FLOP/s.
    bw_frac   — achieved fraction of peak HBM bandwidth.
    headroom  — wall_s / target_s (1.0 = speed of light).
    """
    peaks = chip_peaks(device)
    peak_f = peaks.get(dtype, peaks["f32"])
    t_compute = flops / peak_f
    t_memory = bytes_ / peaks["hbm"]
    target = max(t_compute, t_memory)
    return {
        "flops": flops, "bytes": bytes_, "wall_s": wall_s,
        "target_s": target,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "mfu": flops / peak_f / wall_s if wall_s > 0 else 0.0,
        "bw_frac": bytes_ / peaks["hbm"] / wall_s if wall_s > 0 else 0.0,
        "headroom": wall_s / target if target > 0 else float("inf"),
    }


def format_roofline(label: str, r: Dict[str, float]) -> str:
    """One aligned report line (printed alongside wall-clock)."""
    return (f"{label:>24}: {r['wall_s'] * 1e3:8.3f} ms  "
            f"target {r['target_s'] * 1e3:7.3f} ms "
            f"({r['bound']}-bound)  x{r['headroom']:.1f} off  "
            f"MFU {r['mfu'] * 100:5.2f}%  BW {r['bw_frac'] * 100:5.1f}%  "
            f"[{r['flops'] / 1e9:.2f} GF, {r['bytes'] / 1e6:.1f} MB]")
