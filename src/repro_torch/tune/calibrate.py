"""Measured-roofline PMS calibration: fit a `GPUSpec` to the card at hand.

Counterpart of `repro.tune.calibrate`.  The PMS (core/pms.py) prices every
candidate configuration with two constants, `hbm_bw` and `peak_flops_f32`,
that ship as H100 data-sheet values.  This module measures what the card
achieves and fits the constants to it, as the reference does:

  * Microbenchmarks, timed on the card with CUDA events (best of `reps`
    after a warm-up): a device-to-device copy of a buffer far larger than
    L2 for the memory rate, and an fp32 matrix product with TF32 off (the
    CUDA cores, where the port's kernels run) for the fp32 rate.  They
    bound what the card can do, and are the fit's fallback where it is
    degenerate.
  * Block-sweep fit: run the planned CP-ALS sweep at several controller
    configurations, read each workspace's exact byte and flop counts off
    the PMS itself (a unit-constant `GPUSpec` turns `pms_estimates()` into
    a counter), and least-squares fit
    ``t_measured ~ bytes / hbm_bw + flops / peak_flops_f32``.  The fitted
    constants are *effective* rates: they absorb everything else the sweep
    does (on the card, mostly the CP fit), which is what makes the PMS's
    sweep predictions land near measured time.  Where bytes and flops come
    out collinear (lane padding to 4 leaves the flops a fixed multiple of
    the non-zeros), a constant falls back to its microbenchmark.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence

import numpy as np
import torch

from ..core.memctrl import CacheEngineConfig, DMAEngineConfig, GPUSpec, MemoryControllerConfig
from ..device import resolve_device
from ..obs import trace as _trace
from .cache import AutotuneCache, current_backend, default_cache

__all__ = [
    "CalibSample",
    "CalibrationResult",
    "DEFAULT_CALIBRATION_CFGS",
    "measure_hbm_bw",
    "measure_peak_flops_f32",
    "roofline_counts",
    "l2_bytes",
    "sweep_sample",
    "fit_spec",
    "predicted_seconds",
    "calibrate",
    "calibrate_and_store",
    "resolve_spec",
]

#: With hbm_bw == peak_flops_f32 == l2_bw == 1, `t_mem` IS the HBM byte
#: count, `t_l2` the L2 byte count and `t_compute` the flop count.
_UNIT_SPEC = GPUSpec(hbm_bw=1.0, peak_flops_f32=1.0, l2_bw=1.0)

#: The reference's calibration configurations: tile_i and blk vary the
#: layout's byte counts (and, on the reference's TPU model, the flops).
DEFAULT_CALIBRATION_CFGS: tuple[MemoryControllerConfig, ...] = (
    MemoryControllerConfig(
        cache=CacheEngineConfig(tile_i=128, tile_j=128, tile_k=128),
        dma=DMAEngineConfig(blk=128),
    ),
    MemoryControllerConfig(),  # the 256-cube default
    MemoryControllerConfig(
        cache=CacheEngineConfig(tile_i=512, tile_j=512, tile_k=512),
        dma=DMAEngineConfig(blk=512),
    ),
)


# ---------------------------------------------------------------------------
# Microbenchmarks (on the card only)
# ---------------------------------------------------------------------------


def _card(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the microbenchmarks time a CUDA device, got {dev}")
    return dev


def _best_ms(fn, reps: int) -> float:
    """Least CUDA-event time (ms) of one `fn()` call, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(max(1, reps)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def measure_hbm_bw(nbytes: int = 1 << 30, reps: int = 5, device=None) -> float:
    """Memory rate of the card (bytes/s): a device-to-device copy of an
    `nbytes` float32 buffer (one read and one write per element), far
    larger than L2."""
    dev = _card(device)
    n = max(1, nbytes // 4)
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    ms = _best_ms(lambda: y.copy_(x), reps)
    return 2 * 4 * n / (ms * 1e-3)


def measure_peak_flops_f32(size: int = 8192, reps: int = 5, device=None) -> float:
    """fp32 rate of the card (FLOP/s) outside the tensor cores: a (size,
    size) @ (size, size) float32 product with TF32 off (2 size^3 flops)."""
    dev = _card(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((size, size), generator=gen, device=dev)
    b = torch.randn((size, size), generator=gen, device=dev)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms = _best_ms(lambda: a @ b, reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return 2.0 * size**3 / (ms * 1e-3)


# ---------------------------------------------------------------------------
# Block-sweep samples
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CalibSample:
    """One measured sweep at one controller configuration: the exact PMS
    byte and flop counts of the built workspace, per output mode, and the
    measured steady-state seconds per sweep."""

    label: str
    per_mode: tuple[tuple[float, float], ...]  # (mem_bytes, flops) per mode
    measured_s: float
    # The bytes the PMS prices at the L2 rate (gathers and flushes), summed
    # over the modes: `fit_spec` takes their time off the measured time, so
    # it fits the HBM rate to the HBM bytes alone.
    l2_bytes: float = 0.0

    @property
    def mem_bytes(self) -> float:
        return float(sum(b for b, _ in self.per_mode))

    @property
    def flops(self) -> float:
        return float(sum(f for _, f in self.per_mode))


def roofline_counts(ws) -> tuple[tuple[float, float], ...]:
    """Exact (HBM bytes, flops) per output mode of a planned workspace, read
    off the PMS with the unit-constant spec."""
    ests = ws.pms_estimates(_UNIT_SPEC)
    return tuple((float(ests[m].t_mem), float(ests[m].t_compute)) for m in sorted(ests))


def l2_bytes(ws) -> float:
    """The bytes the PMS prices at the L2 rate for a planned workspace,
    summed over its modes (unit-constant spec)."""
    return float(sum(e.t_l2 for e in ws.pms_estimates(_UNIT_SPEC).values()))


def predicted_seconds(per_mode: Sequence[tuple[float, float]], spec: GPUSpec) -> float:
    """Re-price stored byte and flop counts under a spec with the PMS's
    max-form roofline (per mode max(t_mem, t_compute), summed)."""
    return float(sum(max(b / spec.hbm_bw, f / spec.peak_flops_f32) for b, f in per_mode))


def _cfg_label(cfg: MemoryControllerConfig) -> str:
    c, d = cfg.cache, cfg.dma
    return f"tiles=({c.tile_i},{c.tile_j},{c.tile_k}),blk={d.blk}"


def sweep_sample(st, rank: int, cfg: MemoryControllerConfig, *, reps: int = 2, seed: int = 0,
                 device=None) -> CalibSample:
    """Build the planned CP-ALS workspace at `cfg` on `device` (CUDA unless
    given), time its steady-state sweep (a first and a warm sweep, then the
    best of `reps`: CUDA events on the card, the host clock on the CPU), and
    pair the time with the workspace's exact byte and flop counts."""
    from ..core.coo import norm_sq, to_device
    from ..kernels.ops import make_planned_cp_als

    dev = resolve_device(device)
    ws = make_planned_cp_als(st, rank, cfg=cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    facs = ws.pad_factors([torch.randn((s, rank), generator=gen, device=dev) / math.sqrt(rank)
                           for s in st.shape])
    idx, val = to_device(st, dev)
    nxs = torch.tensor(norm_sq(st), dtype=torch.float32, device=dev)
    facs, _, _ = ws.sweep(facs, idx, val, nxs, first=True)
    if dev.type == "cuda":
        best = _best_ms(lambda: ws.sweep(facs, idx, val, nxs), reps) * 1e-3
    else:
        ws.sweep(facs, idx, val, nxs)
        best = math.inf
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            ws.sweep(facs, idx, val, nxs)
            best = min(best, time.perf_counter() - t0)
    return CalibSample(label=_cfg_label(cfg), per_mode=roofline_counts(ws), measured_s=best,
                       l2_bytes=l2_bytes(ws))


# ---------------------------------------------------------------------------
# Least-squares fit
# ---------------------------------------------------------------------------


def fit_spec(
    samples: Sequence[CalibSample],
    base: GPUSpec = GPUSpec(),
    *,
    fallback_hbm_bw: float | None = None,
    fallback_peak_flops: float | None = None,
) -> GPUSpec:
    """Least-squares fit of (hbm_bw, peak_flops_f32) from measured sweeps.

    Solves ``t_i ~ bytes_i * x0 + flops_i * x1`` for x = (1/hbm_bw,
    1/peak_flops_f32) over the samples' totals, t_i being the measured
    time less the sample's L2 bytes at `base.l2_bw` (the port's PMS prices
    gathers and flushes at L2's rate, which this fit leaves as it is).  If a coefficient comes
    back non-positive (collinear samples, or one term noise-small), that
    constant falls back to the microbenchmark value (or `base`'s) and the
    other is refit alone.  `peak_flops` (bf16) keeps `base`'s bf16-to-fp32
    ratio.  The reference's solution to the bit for samples without L2
    bytes.  Raises ValueError on an empty sample list or a non-positive
    time."""
    if not samples:
        raise ValueError("fit_spec needs at least one calibration sample")
    B = np.array([s.mem_bytes for s in samples], dtype=np.float64)
    F = np.array([s.flops for s in samples], dtype=np.float64)
    # The L2 terms' time at the base spec's rate comes off first: the fit
    # prices HBM bytes and flops only.
    t = np.array([s.measured_s - s.l2_bytes / base.l2_bw for s in samples], dtype=np.float64)
    if np.any(t <= 0):
        raise ValueError("calibration samples must have measured_s > 0, and more than the "
                         "time of their L2 bytes at the base spec's l2_bw")
    A = np.stack([B, F], axis=1)
    x, *_ = np.linalg.lstsq(A, t, rcond=None)
    inv_bw, inv_pf = float(x[0]), float(x[1])
    if inv_bw <= 0 and inv_pf <= 0:
        inv_bw = 1.0 / (fallback_hbm_bw or base.hbm_bw)
        inv_pf = 1.0 / (fallback_peak_flops or base.peak_flops_f32)
    elif inv_pf <= 0:
        inv_pf = 1.0 / (fallback_peak_flops or base.peak_flops_f32)
        inv_bw = float(np.dot(B, t - F * inv_pf) / np.dot(B, B))
        inv_bw = max(inv_bw, np.finfo(np.float64).tiny)
    elif inv_bw <= 0:
        inv_bw = 1.0 / (fallback_hbm_bw or base.hbm_bw)
        inv_pf = float(np.dot(F, t - B * inv_bw) / np.dot(F, F))
        inv_pf = max(inv_pf, np.finfo(np.float64).tiny)
    bf16_ratio = base.peak_flops / base.peak_flops_f32
    fitted_f32 = 1.0 / inv_pf
    return dataclasses.replace(
        base, hbm_bw=1.0 / inv_bw, peak_flops_f32=fitted_f32, peak_flops=fitted_f32 * bf16_ratio)


# ---------------------------------------------------------------------------
# The end-to-end calibration workflow
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """What one calibration run learned: the fitted spec, the measurements
    behind it, the microbenchmark rates, and the achieved_pct of every
    sample under the default and the fitted spec."""

    spec: GPUSpec
    backend: str
    samples: tuple[CalibSample, ...]
    stream_hbm_bw: float | None
    matmul_peak_flops_f32: float | None
    validation: tuple[dict, ...]

    @property
    def residual_rel(self) -> float:
        """Mean relative error of the fitted sum-form model over the
        samples."""
        errs = [abs(s.mem_bytes / self.spec.hbm_bw + s.flops / self.spec.peak_flops_f32
                    + s.l2_bytes / self.spec.l2_bw - s.measured_s) / s.measured_s
                for s in self.samples]
        return float(np.mean(errs)) if errs else float("nan")


def _validation_rows(samples: Sequence[CalibSample], fitted: GPUSpec, base: GPUSpec,
                     preset: str) -> tuple[dict, ...]:
    """Re-price every sample as an `obs.calibrate.CalibrationRow` under the
    default and the fitted spec."""
    from ..obs.calibrate import CalibrationRow

    rows = []
    for s in samples:
        default = CalibrationRow("cp", preset, predicted_seconds(s.per_mode, base), s.measured_s)
        measured = CalibrationRow("cp", preset, predicted_seconds(s.per_mode, fitted), s.measured_s)
        rows.append({"label": s.label, "measured_s": s.measured_s,
                     "achieved_pct_default": default.achieved_pct,
                     "achieved_pct_measured": measured.achieved_pct})
    return tuple(rows)


def _backend_of(dev: torch.device) -> str:
    return "cpu" if dev.type == "cpu" else current_backend()


def calibrate(
    preset: str = "tiny",
    *,
    rank: int = 8,
    cfgs: Sequence[MemoryControllerConfig] = DEFAULT_CALIBRATION_CFGS,
    reps: int = 2,
    base: GPUSpec = GPUSpec(),
    microbench: bool = True,
    seed: int = 0,
    device=None,
) -> CalibrationResult:
    """The calibration workflow on `device` (CUDA unless given): the
    microbenchmarks (card only), one block-sweep sample per configuration
    in `cfgs` on the `frostt_like(preset)` tensor, the least-squares fit
    and the validation rows, traced as a `tune_calibrate` span.  Writes
    nothing: `calibrate_and_store` persists."""
    from ..core.coo import frostt_like

    dev = resolve_device(device)
    backend = _backend_of(dev)
    with _trace.span("tune_calibrate", backend=backend, preset=preset):
        bw = measure_hbm_bw(device=dev) if microbench else None
        pf = measure_peak_flops_f32(device=dev) if microbench else None
        st = frostt_like(preset)
        samples = tuple(sweep_sample(st, rank, cfg, reps=reps, seed=seed, device=dev) for cfg in cfgs)
        fitted = fit_spec(samples, base, fallback_hbm_bw=bw, fallback_peak_flops=pf)
        return CalibrationResult(spec=fitted, backend=backend, samples=samples,
                                 stream_hbm_bw=bw, matmul_peak_flops_f32=pf,
                                 validation=_validation_rows(samples, fitted, base, preset))


#: Smaller workload for the implicit `spec="measured"` cache-miss path.
QUICK_CALIBRATION_KWARGS = dict(preset="tiny", rank=8, cfgs=DEFAULT_CALIBRATION_CFGS[:2], reps=1)


def calibrate_and_store(*, cache: AutotuneCache | None = None, **kwargs) -> CalibrationResult:
    """`calibrate()`, then persist the fitted spec for its backend in the
    autotune cache (where `pms.search(spec="measured")` finds it)."""
    cache = cache if cache is not None else default_cache()
    result = calibrate(**kwargs)
    cache.put_spec(
        result.backend,
        result.spec,
        fitted_at=time.time(),
        residual_rel=result.residual_rel,
        stream_hbm_bw=result.stream_hbm_bw,
        matmul_peak_flops_f32=result.matmul_peak_flops_f32,
        n_samples=len(result.samples),
    )
    return result


def resolve_spec(spec, *, cache: AutotuneCache | None = None, calibrate_on_miss: bool = True):
    """Resolve the `spec=` argument every PMS entry point takes:

      * a `GPUSpec` passes through;
      * "default" is the data-sheet `GPUSpec()`;
      * "measured" is this backend's fitted spec from the autotune cache;
        on a miss, a quick calibration on the card runs and persists
        (`QUICK_CALIBRATION_KWARGS`) when `calibrate_on_miss` is set,
        otherwise ValueError.
    """
    if isinstance(spec, GPUSpec):
        return spec
    if spec == "default":
        return GPUSpec()
    if spec != "measured":
        raise ValueError(f"unknown spec {spec!r}: expected a GPUSpec, 'default' or 'measured'")
    cache = cache if cache is not None else default_cache()
    found = cache.get_spec(current_backend())
    if found is not None:
        return found
    if not calibrate_on_miss:
        raise ValueError(
            f"no fitted spec for backend {current_backend()!r} in {cache.path}; run "
            f"repro_torch.tune.calibrate_and_store() on the card first")
    return calibrate_and_store(cache=cache, **QUICK_CALIBRATION_KWARGS).spec
