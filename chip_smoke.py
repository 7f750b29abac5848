"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, runs CP-ALS, Tucker HOOI and
TT-ALS at NELL-2's published size (12,092 x 9,184 x 28,818, 76,879,419 non-zeros,
synthetic stand-in with seed 0 and zipf skew 1.1) through
`repro_torch.api.decompose`, and measures the kernels.  Phases, each
printing one JSON line:

  a  device   the card (nvidia-smi name and power limit), CUDA version
  b  build    nvcc build of every kernel, seconds, ptxas report
  c  check    kernel vs plain version on 3-, 4- and 5-mode presets (at rank
              16, at rank 256, and at tile_i 8,192, which take row parts)
              and on every mode of the NELL-2-size tensor; 20 launches per
              mode on a hot-row tensor at ranks 16 and 256 in two
              geometries, each within 1e-5 of float64; CUDA vs CPU CP-ALS
              fits on a small tensor; kernel, plain and sweep timings, and
              the MTTKRP kernel before its run sums were split into
              sub-chains (scripts/probe_kernels/mttkrp_pr18.cu) timed
              beside it
  d  main     decompose(st, 16, format="cp", iters=5, seed=0) with the launch
              counters reset just before and read just after
  e  check    TTMc kernel vs plain version on 3-, 4- and 5-mode presets with
              mixed core ranks (also at tile_i 8,192), on a (200, 200, 200)
              tensor at core ranks (100, 8, 100) and on every mode of the
              NELL-2-size tensor at core ranks (16, 16, 16); CUDA vs CPU HOOI
              fits on a small tensor; kernel, plain, sweep and sweep-part
              timings, and the staged TTMc kernel it replaced
              (scripts/probe_kernels/ttmc_pr16.cu) timed beside it
  f  main     decompose(st, (16, 16, 16), format="tucker", iters=5, seed=0)
              with the launch counters reset just before and read just after
  g  check    TT-core kernel vs plain version on 3-, 4- and 5-mode presets
              with mixed TT ranks, on the (200, 200, 200) tensor at TT ranks
              (100, 100) and on every mode of the NELL-2-size tensor
              at TT ranks (16, 16); CUDA vs CPU TT-ALS fits on a small
              tensor; kernel, plain, sweep and sweep-part timings
  h  main     decompose(st, (16, 16), format="tt", iters=5, init="random",
              seed=0) with the launch counters reset just before and read
              just after
  i  pms      the PMS and auto-tuning on the same tensor: hypergraph stats
              and the analytic search per kernel and mode (host seconds,
              top 5); each kernel timed at the search's top 3, the default,
              its last 2 (of at most 500 M slots) and every tile at 1,024
              (MTTKRP on every mode, TTMc on mode 0, TT-core on modes 0 and
              1), beside the exact prediction and each of its terms, its
              achieved share and the Spearman rank of predicted against
              measured (at least 0.5 where the times spread more than 10%);
              the picks and the default held to their float64 plain
              version; the first pick in turns with the default (at most
              2% slower); decompose(..., auto_tune=True) for CP, Tucker and
              TT with the launch counters read, fits held to phases d, f and
              h, the tuned sweep in turns with the default's (no slower than
              the default's spread); a warm auto_tune="cached" call that
              evaluates no configuration (the search's picks held in the
              cache, the fit within 1e-5 of the first call's); the calibration
              microbenchmarks and the block-sweep fit of the PMS's rates
  j  slice    the non-planned methods on the same tensor: CP rank 16 from
              phase d's initial factors by approach 1 and 2 on the remap
              and copies layouts (sweep, MTTKRP and remap ms per mode, peak
              memory, fits against phase d's, MTTKRP error against
              float64, the paper's Table 1 traffic beside the measured
              times); remap_stable against remap_radix per mode (pointer
              budget 4,096, orders equal bit for bit); Tucker and TT
              method="reference"; mttkrp_auto (a plan-cache miss, then a
              hit), tucker_auto and tt_auto against their chunked float64
              references; the plan cache cleared at the end
  k  wide     fault F3 on the card: a 6-mode tensor (4,096 x 4,096 x 2,048 x
              1,024 x 512 x 256, 10 M non-zeros) and a 7-mode one (2 M),
              plans of 5 and 6 input modes on the kernels' wide paths: each
              kernel against float64 on every mode (MTTKRP rank 16, TTMc at
              core ranks 4 each, TT-core at TT ranks 4 each), timed per mode
              beside its bound, and CP, Tucker and TT decompose for 3
              iterations with the launch counters read; tracing on the card:
              decompose(..., trace=path) for CP, Tucker and TT at NELL-2 size
              (span counts and nesting, the steady sweep spans against
              phases d, f and h, join_trace's achieved_pct) and the sweep
              with tracing on against off, in turns; the three kernels at
              NELL-2 size per mode in turns with their sources as they were
              before the wide paths (scripts/probe_kernels/*_before_wide.cu)
  l  resil.   the resilience layer at NELL-2 size: a clean rerun of each
              format (its peak device memory against the workspace's
              admission_bytes; its fits against phases d, f and h, the
              run-to-run gap); CP drive sweeps in turns with guards off,
              "raise", "fallback" and check_factors_every=1, and the bare
              sweep-and-sync loop; a NaN injected
              after iteration 1 into CP, Tucker and TT under "restart" and
              "fallback" (events, launches after the switch, the fallback
              sweeps' ms, final fits against the clean runs); CP and TT
              killed in a subprocess before iteration 3 (exit 17) and
              resumed from their checkpoints (restored factors and fits
              bit for bit, later fits against a clean run, ms per
              checkpoint_save); a budget one byte under the CP default's
              footprint (admitted at blk 128); on a preset, a budget under
              every rung down to blk 8 (approach 1) and an impossible one
              (AdmissionError); each kernel at blk 64, 32, 16 and 8 on the
              presets against float64

then the `kernels` line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero before that line.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.api import decompose  # noqa: E402
from repro_torch.core import pms  # noqa: E402
from repro_torch.core.coo import frostt_like, synthetic_tensor, to_device  # noqa: E402
from repro_torch.core.cp_als import (  # noqa: E402
    LAYOUTS,
    _initial_factors,
    _sweep_remap,
    _sweep_streams,
    fit_value,
)
from repro_torch.core.hypergraph import approach1_traffic, approach2_traffic  # noqa: E402
from repro_torch.core.hypergraph import stats as hg_stats  # noqa: E402
from repro_torch.core.mttkrp import hadamard_rows, mttkrp  # noqa: E402
from repro_torch.core.remap import radix_digits, remap_radix, remap_stable  # noqa: E402
from repro_torch.core.memctrl import (  # noqa: E402
    CacheEngineConfig,
    DMAEngineConfig,
    GPUSpec,
    MemoryControllerConfig,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mttkrp import mttkrp_blocked, mttkrp_blocked_plain, rank_padded  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    _tt_bond_pairs,
    make_planned_cp_als,
    make_planned_mttkrp,
    make_planned_ttcore,
    make_planned_ttmc,
    mttkrp_auto,
    plan_cache_clear,
    plan_cache_stats,
    tt_auto,
    tucker_auto,
)
from repro_torch.kernels.ref import ttcore_ref, ttmc_ref  # noqa: E402
from repro_torch.api import _lane_ranks  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    FLOOR_BLK,
    AdmissionError,
    GuardConfig,
    admission_bytes,
    reference_footprint_bytes,
)
from repro_torch.testing import faults  # noqa: E402
from repro_torch.train import CheckpointManager  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.calibrate import join_trace  # noqa: E402
from repro_torch.kernels.tt import ttcore_blocked, ttcore_blocked_plain  # noqa: E402
from repro_torch.kernels.ttm import kron_cols, ttmc_blocked, ttmc_blocked_plain  # noqa: E402
from repro_torch.tt.als import (  # noqa: E402
    _fit_from,
    _p_next,
    _q_suffix,
    _solve_core,
    core_to_matrix,
    init_tt_cores,
    make_planned_tt,
    matrix_to_core,
    tt_inner,
)
from repro_torch.tune import (  # noqa: E402
    DEFAULT_CALIBRATION_CFGS,
    cached_config,
    fit_spec,
    measure_hbm_bw,
    measure_peak_flops_f32,
    predicted_seconds,
    sweep_sample,
)
from repro_torch.tucker.hooi import (  # noqa: E402
    _core_from_unfolding,
    _factor_from_unfolding,
    core_fit_value,
    init_tucker_factors,
    make_planned_tucker,
)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores.  Used for the kernel's least possible time (bound_ms).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

ROOT = Path(__file__).resolve().parent
RANK = 16
# An output tile of 8,192 rows, which the MTTKRP and TTMc kernels take in
# row parts; checked on the presets, not timed.
BIG_TILE = MemoryControllerConfig(cache=CacheEngineConfig(tile_i=8192))
# The MTTKRP and TTMc kernels that the current ones replaced, built and
# timed beside them.
EARLIER_MTTKRP = ROOT / "scripts" / "probe_kernels" / "mttkrp_pr18.cu"
EARLIER_TTMC = ROOT / "scripts" / "probe_kernels" / "ttmc_pr16.cu"
# The three kernels' sources as they were before their wide paths, timed in
# turns with the current ones in phase k.
BEFORE_WIDE = {k: ROOT / "scripts" / "probe_kernels" / f"{k}_before_wide.cu"
               for k in ("mttkrp", "ttmc", "ttcore")}
# Widths that the kernels take in column slices or smaller steps, on the
# presets (CP) and on WIDE_SHAPE (Tucker, TT): never shrunk to fit.
WIDE_RANK = 256
WIDE_SHAPE, WIDE_NNZ, WIDE_SKEW = (200, 200, 200), 5_000, 0.8
WIDE_CORE_RANKS = (100, 8, 100)  # mode 1's input ranks sum to 200
WIDE_TT_RANKS = (100, 100)
CORE_RANKS = (16, 16, 16)  # Tucker at NELL-2 size: 256 Kronecker columns per row
# Mixed core ranks on the presets: equal ones would hide a transposed
# Kronecker digit order.
PRESET_CORE_RANKS = {"tiny": (3, 5, 2), "4d_small": (5, 4, 6, 3), "5d_small": (3, 4, 2, 5, 3)}
ITERS = 5
NELL2_SHAPE = (12_092, 9_184, 28_818)
NELL2_NNZ = 76_879_419
NELL2_SKEW = 1.1
PRESETS = ("tiny", "4d_small", "5d_small")
# A tensor whose hottest rows hold most of every block range (zipf 3 on
# 2,000 rows), checked at ranks 16 and 256 in two geometries, HOT_LAUNCHES
# launches per mode: the order of a hot row's float32 sums varies from
# launch to launch, and each launch must stay within TOL_PRESET.
HOT_SHAPE, HOT_NNZ, HOT_SKEW = (2_000, 300, 400), 50_000, 3.0
HOT_RANKS = (16, 256)
HOT_GEOMETRIES = {
    "default": MemoryControllerConfig(),
    "small_tiles_wide_blocks": MemoryControllerConfig(
        cache=CacheEngineConfig(tile_i=8, tile_j=16, tile_k=4), dma=DMAEngineConfig(blk=640)),
}
HOT_LAUNCHES = 20
# Kernel vs its plain version evaluated in float64 on the same float32
# inputs: the largest error relative to each output column's max.  The kernel
# sums in float32 with atomics, in a varying order; the error grows with the
# contributions per output row (a hot row of the zipf tensor at NELL-2 size
# collects millions).  The float64 evaluation keeps the plain version's own
# rounding out of the measurement (its float32 evaluation, index_add_ on the
# card, is an atomic float32 sum too); its float32 error is reported beside.
TOL_PRESET = 1e-5
TOL_FULL = 1e-4
# CUDA vs CPU CP-ALS on the small tensor: the same float32 algorithm with
# sums taken in another order; the ROADMAP's fit bar.
TOL_FIT = 1e-5
# Fit may not drop by more than this between iterations (ALS and HOOI are
# monotone up to float32 rounding).
FIT_DROP = 1e-5
# ||U^T U - I|| (max entry) of HOOI's factors after phase f: float32 Gram
# and eigh on unfoldings of up to 28,818 rows.
ORTHO_TOL = 1e-4
TT_RANKS = (16, 16)  # TT at NELL-2 size: W_1 is 9,184 x 256, mode 1's output 256 columns
# Mixed TT ranks on the presets: bonds that change at every chain step.
PRESET_TT_RANKS = {"tiny": (3, 5), "4d_small": (4, 3, 5), "5d_small": (2, 4, 3, 2)}
KERNEL_REPS = 20
PLAIN_REPS = 3
# The TTMc plain version takes seconds per call at NELL-2 size.
TTMC_PLAIN_REPS = 1
SWEEP_REPS = 3
# Phase i: the search's best configurations built and timed per kernel, the
# configurations listed per search, and the modes the TTMc and TT-core
# kernels are timed on (TT-core's middle mode takes row parts; modes 0 and
# 2 are alike).
PMS_TIMED = 3
PMS_LISTED = 5
PMS_MODES = {"mttkrp": (0, 1, 2), "ttmc": (0,), "tt": (0, 1)}
# Beside the picks and the default, phase i times the PMS's last-ranked
# configurations (PMS_LAST of them), leaving out those whose layout the
# occupancy model puts past PMS_MAX_SLOTS slots (small tiles at large
# blocks: mostly padding, a plan the card cannot build beside its
# temporaries), and every tile at 1,024.  Where the times spread more than
# PMS_SPREAD (max over min), the Spearman rank of predicted against
# measured must reach PMS_SPEARMAN_MIN; each first pick, timed in turns
# with the default (PICK_TURNS), may be at most PICK_SLOWDOWN slower.
PMS_LAST = 2
PMS_MAX_SLOTS = 500_000_000
PMS_ALL_1024 = MemoryControllerConfig(cache=CacheEngineConfig(tile_i=1024, tile_j=1024, tile_k=1024))
PMS_SPREAD = 1.10
PMS_SPEARMAN_MIN = 0.5
PICK_SLOWDOWN = 1.02
PICK_TURNS = ("pick", "default", "default", "pick")
SWEEP_TURNS = ("default", "tuned", "tuned", "default")
# Fits of the auto-tuned runs against phases d, f and h: the same algorithm
# on other plan geometries, float32 sums in another order.
TOL_TUNED_FIT = 1e-4
# Phase j: the compute patterns, the Remapper's pointer budget (4,096
# pointers a pass: two passes on every NELL-2 mode), repetitions of the
# per-mode timings, the reference methods' iterations, and the non-zeros
# per step of the float64 MTTKRP reference.
PATTERNS = ("approach1", "approach2")
POINTER_BUDGET = 4096
PATTERN_REPS = 3
REF_ITERS = 2
EXACT_CHUNK = 1 << 23
# Phase k: fault F3's tensors, of 6 and 7 modes (plans of 5 and 6 input
# modes: the kernels' wide paths), at their ranks; iterations of their
# decompose runs and launches per timing.
WIDE_MODE_TENSORS = {5: ((4096, 4096, 2048, 1024, 512, 256), 10_000_000),
                     6: ((2048, 2048, 1024, 512, 256, 128, 64), 2_000_000)}
WIDE_MODE_SKEW = 1.1
WIDE_MODE_RANK = 4  # every Tucker core rank and TT rank; CP takes RANK
WIDE_MODE_ITERS = 3
WIDE_MODE_REPS = 5
# The kernels' NELL-2 times per mode (ms) as phases c, e and g measured them
# before the wide paths were added, on "NVIDIA H100 80GB HBM3, 700.00 W"
# (PERF.md), printed beside this run's.
BEFORE_WIDE_RUN_MS = {"mttkrp": [2.20, 2.21, 2.19], "ttmc": [8.51, 8.48, 8.48],
                      "ttcore": [12.92, 29.12, 9.42]}
# The kernels' slowdown against their sources before the wide paths, timed
# in turns, may not pass this.
BEFORE_WIDE_SLOWDOWN = 1.02
BEFORE_WIDE_TURNS = 3
# Tracing: the steady sweep spans against phases d, f and h's sweep times,
# and the traced sweep against the untraced one (in turns), at most.
TRACE_SWEEP_TOL = 0.05
TRACE_OVERHEAD = 1.03
TRACE_TURNS = ("on", "off", "off", "on")
# Phase l: the resilience layer.  The guard settings timed in turns on one
# CP workspace with the bare sweep-and-sync loop ("sync"); an unguarded
# drive's steady sweep against that loop's, at most this far apart; a recovered run's final fit against its clean run's;
# the iteration a killed subprocess dies before, and its exit code; the
# preset the full admission ladder runs on, and the ladder's blocks each
# kernel is held to float64 at.
GUARD_SETTINGS = {"off": None, "raise": GuardConfig("raise"), "fallback": GuardConfig("fallback"),
                  "factors_every_1": GuardConfig("raise", check_factors_every=1)}
GUARD_TURNS = ("off", "sync", "raise", "fallback", "factors_every_1",
               "factors_every_1", "fallback", "raise", "sync", "off")
UNGUARDED_SWEEP_TOL = 0.01
# The drive syncs each iteration's fit to the host, where phase d's sweeps
# run back to back: 0.7-1.4% on the CP sweep on an H100.
DRIVE_SYNC_TOL = 0.03
TOL_RECOVERED = 1e-4
KILL_AT = 3
KILL_CODE = 17
LADDER_PRESET = "4d_small"
LADDER_BLKS = (64, 32, 16, 8)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def errors(got: torch.Tensor, exact: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max error relative to each column's max of exact)."""
    diff = (got.double() - exact).abs()
    col = exact.abs().amax(0).clamp_min(1e-300)
    return float(diff.max()), float((diff.amax(0) / col).max())


def check_kernel(kernel, plain, plan, facs, *extra, tol: float, what: str) -> dict:
    """Kernel vs its plain version in float64 (and the plain version in
    float32 vs the same), on the same inputs.  Every output column counts,
    padded lanes included: their exact value is 0."""
    ker = kernel(plan, facs, *extra)
    torch.cuda.synchronize()
    exact = plain(dataclasses.replace(plan, vals=plan.vals.double()), [f.double() for f in facs], *extra)
    abs_err, rel_err = errors(ker, exact)
    del ker
    plain_abs, plain_rel = errors(plain(plan, facs, *extra), exact)
    check(rel_err <= tol, f"{what}: kernel rel err {rel_err} > {tol}")
    return {"max_abs_err": abs_err, "max_rel_err": rel_err,
            "plain_f32_max_abs_err": plain_abs, "plain_f32_max_rel_err": plain_rel}


def bound(shape, nnz: int, mode: int, rank: int) -> tuple[float, str]:
    """Least time (ms) for one mode's MTTKRP on this data: each input read
    once (the true nnz stream of value + N indices, each input factor),
    the output written once; flops = N per non-zero and rank column."""
    n = len(shape)
    nbytes = nnz * 4 * (1 + n) + sum(shape) * rank * 4
    flops = nnz * rank * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ttmc_bound(shape, nnz: int, mode: int, core_ranks) -> tuple[float, str]:
    """Least time (ms) for one mode's TTMc on this data: each input read once
    (the true nnz stream of value + N indices, each input factor's true
    lanes), the output's true columns written once; flops per non-zero =
    the multiplies of the Kronecker chain (r_a, r_a*r_b, ...) plus one add
    per output column."""
    in_ranks = [r for m, r in enumerate(core_ranks) if m != mode]
    ncols = kron_cols(in_ranks)
    nbytes = (nnz * 4 * (1 + len(shape))
              + sum(s * r for m, (s, r) in enumerate(zip(shape, core_ranks)) if m != mode) * 4
              + shape[mode] * ncols * 4)
    flops = nnz * (sum(math.prod(in_ranks[: k + 1]) for k in range(len(in_ranks))) + ncols)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ttcore_bound(shape, nnz: int, mode: int, tt_ranks) -> tuple[float, str]:
    """Least time (ms) for one mode's TT-core update on this data: each
    input read once (the true nnz stream of value + N indices, each input
    interface matrix's true lanes), the output's true columns written once;
    flops per non-zero as the kernel does them: a multiply-add per matrix
    element of each chain step after a chain's first (the first is the
    gathered row itself), rl_m multiplies to fold the value into the left
    vector, and a multiply and an add per output column."""
    pairs = _tt_bond_pairs(tt_ranks, len(shape))
    rl_m, rr_m = pairs[mode]
    left, right = pairs[:mode], pairs[mode + 1:]
    chain = sum(2 * a * b for a, b in left[1:]) + sum(2 * a * b for a, b in right[:-1])
    nbytes = (nnz * 4 * (1 + len(shape))
              + sum(s * a * b for m, (s, (a, b)) in enumerate(zip(shape, pairs)) if m != mode) * 4
              + shape[mode] * rl_m * rr_m * 4)
    flops = nnz * (chain + rl_m + 2 * rl_m * rr_m)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def random_padded(plan, widths, gen: torch.Generator) -> list[torch.Tensor]:
    return [torch.randn((rows, w), generator=gen, device="cuda") for rows, w in zip(plan.in_rows, widths)]


def start_nvcc(src: Path, lib: Path) -> subprocess.Popen:
    """Start building `src` into `lib` (its headers from its own directory)."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@contextlib.contextmanager
def kernel_library(kernel: str, lib: ctypes.CDLL):
    """Make the wrapper of `kernel` ("mttkrp", "ttmc") launch from `lib`
    inside the block."""
    real = build.load
    build.load = lambda name: lib if name == kernel else real(name)
    try:
        yield
    finally:
        build.load = real


def reset_launches() -> None:
    mttkrp_blocked.launches = 0
    ttmc_blocked.launches = 0
    ttcore_blocked.launches = 0


def hot_rows(gen: torch.Generator) -> list[dict]:
    """HOT_LAUNCHES launches of the MTTKRP kernel per mode of the hot-row
    tensor, at each rank in HOT_RANKS and geometry in HOT_GEOMETRIES, each
    held to the float64 plain version within TOL_PRESET."""
    st = synthetic_tensor(HOT_SHAPE, HOT_NNZ, seed=0, skew=HOT_SKEW)
    out = []
    for rank in HOT_RANKS:
        for label, cfg in HOT_GEOMETRIES.items():
            ws = make_planned_cp_als(st, rank, cfg=cfg, device="cuda")
            for m in range(st.nmodes):
                plan = ws.plan_for(m)
                facs = random_padded(plan, [rank_padded(rank)] * plan.n_in, gen)
                exact = mttkrp_blocked_plain(dataclasses.replace(plan, vals=plan.vals.double()),
                                             [f.double() for f in facs])
                errs = [errors(mttkrp_blocked(plan, facs), exact)[1] for _ in range(HOT_LAUNCHES)]
                worst = max(errs)
                check(worst <= TOL_PRESET,
                      f"hot rows rank {rank} {label} mode {m}: a launch's rel err {worst} > {TOL_PRESET}")
                out.append({"rank": rank, "geometry": label, "mode": m, "launches": HOT_LAUNCHES,
                            "max_rel_err": worst, "min_rel_err": min(errs),
                            "max_row_nnz": int(st.mode_histogram(m).max())})
            del ws
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1

    # float32 products in full float32 (no TF32), stated and set.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "a", "nvidia_smi": smi, "device": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    earlier_libs = {src: build.BUILD_DIR / "earlier" / src.with_suffix(".so").name
                    for src in (EARLIER_MTTKRP, EARLIER_TTMC, *BEFORE_WIDE.values())}
    # Beside build_all's nvcc processes.
    earlier = {src: start_nvcc(src, lib) for src, lib in earlier_libs.items()}
    libs = build.build_all()
    for src, proc in earlier.items():
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on {src}:\n{out}")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in libs.values() if Path(str(lib) + ".log").is_file()
             for ln in Path(str(lib) + ".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "b", "build_s": build_s, "libraries": sorted(libs), "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(0)
    rp = rank_padded(RANK)
    presets, wide, big = [], [], []
    for preset in PRESETS:
        st = frostt_like(preset)
        for rank, cfg, out in ((RANK, None, presets), (WIDE_RANK, None, wide), (RANK, BIG_TILE, big)):
            ws = make_planned_cp_als(st, rank, cfg=cfg, device="cuda")
            for m in range(st.nmodes):
                plan = ws.plan_for(m)
                facs = random_padded(plan, [rank_padded(rank)] * plan.n_in, gen)
                out.append({"preset": preset, "rank": rank, "tile_i": plan.tile_i, "mode": m,
                            "n_in": plan.n_in,
                            **check_kernel(mttkrp_blocked, mttkrp_blocked_plain, plan, facs,
                                           tol=TOL_PRESET,
                                           what=f"{preset} rank {rank} tile_i {plan.tile_i} mode {m}")})
            del ws

    hot = hot_rows(gen)

    tiny = frostt_like("tiny")
    init = [torch.randn((s, RANK), generator=gen, device="cuda") / math.sqrt(RANK) for s in tiny.shape]
    on_gpu = decompose(tiny, RANK, iters=3, init_factors=init, device="cuda").fit_history
    on_cpu = decompose(tiny, RANK, iters=3, init_factors=[f.cpu() for f in init], device="cpu").fit_history
    fit_gap = max(abs(a - b) for a, b in zip(on_gpu, on_cpu))
    check(fit_gap <= TOL_FIT, f"tiny CP-ALS fits, cuda {on_gpu} vs cpu {on_cpu}")

    t0 = time.perf_counter()
    st = synthetic_tensor(NELL2_SHAPE, NELL2_NNZ, seed=0, skew=NELL2_SKEW)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ws = make_planned_cp_als(st, RANK, device="cuda")
    torch.cuda.synchronize()
    plan_build_s = time.perf_counter() - t0
    earlier_mttkrp = ctypes.CDLL(str(earlier_libs[EARLIER_MTTKRP]))
    modes = []
    for m in range(st.nmodes):
        plan = ws.plan_for(m)
        facs = random_padded(plan, [rp] * plan.n_in, gen)
        errs = check_kernel(mttkrp_blocked, mttkrp_blocked_plain, plan, facs,
                            tol=TOL_FULL, what=f"NELL-2 mode {m}")
        with kernel_library("mttkrp", earlier_mttkrp):
            earlier_errs = check_kernel(mttkrp_blocked, mttkrp_blocked_plain, plan, facs,
                                        tol=TOL_FULL, what=f"NELL-2 mode {m}, earlier kernel")
        bound_ms, bound_by = bound(st.shape, st.nnz, m, RANK)
        # The current kernel and the one it replaced in turns: now, earlier,
        # now, earlier; the least of each.
        now_ms, earlier_ms = [], []
        for _ in range(2):
            now_ms.append(cuda_ms(lambda: mttkrp_blocked(plan, facs), KERNEL_REPS))
            with kernel_library("mttkrp", earlier_mttkrp):
                earlier_ms.append(cuda_ms(lambda: mttkrp_blocked(plan, facs), KERNEL_REPS))
        modes.append({
            "mode": m, "nblocks": plan.nblocks, "slots": plan.nblocks * plan.blk,
            "padding": plan.padding_fraction(), "output_tile_runs": plan.output_tile_runs(),
            **errs, "earlier_kernel_max_rel_err": earlier_errs["max_rel_err"],
            "ms": min(now_ms), "earlier_kernel_ms": min(earlier_ms),
            "plain_ms": cuda_ms(lambda: mttkrp_blocked_plain(plan, facs), PLAIN_REPS),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        del facs
    idx = torch.from_numpy(st.indices).cuda()
    val = torch.from_numpy(st.values).cuda()
    norm_x_sq = torch.tensor(float((st.values.astype("float64") ** 2).sum()), device="cuda")
    facs = ws.pad_factors([torch.randn((s, RANK), generator=gen, device="cuda") / math.sqrt(RANK)
                           for s in st.shape])
    facs, lam, _ = ws.sweep(facs, idx, val, norm_x_sq, first=True)
    sweep_ms = cuda_ms(lambda: ws.sweep(facs, idx, val, norm_x_sq), SWEEP_REPS)
    true = [f[:s, :RANK] for f, s in zip(facs, st.shape)]
    fit_ms = cuda_ms(lambda: fit_value(idx, val, true, lam, norm_x_sq), SWEEP_REPS)
    # Nothing of this phase may stay alive (a NELL-2 plan is 1.7 GB): phase
    # d's peak device memory counts only what decompose holds.
    del ws, plan, facs, lam, true, idx, val, norm_x_sq, init
    torch.cuda.empty_cache()
    emit({"phase": "c", "presets": presets, "wide": wide, "tile_i_8192": big, "hot_rows": hot,
          "tiny_fit_gap_cuda_cpu": fit_gap, "earlier_kernel": str(EARLIER_MTTKRP.relative_to(ROOT)),
          "nell2_modes": modes, "tol_preset": TOL_PRESET, "tol_full": TOL_FULL})

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = decompose(st, RANK, format="cp", iters=ITERS, seed=0)
    torch.cuda.synchronize()
    decompose_s = time.perf_counter() - t0
    launches = mttkrp_blocked.launches
    check(ttmc_blocked.launches == 0 and ttcore_blocked.launches == 0,
          f"CP-ALS launched {ttmc_blocked.launches} TTMc, {ttcore_blocked.launches} TT-core kernels")
    fits = state.fit_history
    check(len(fits) == ITERS and all(math.isfinite(f) for f in fits), f"fits {fits}")
    check(all(b >= a - FIT_DROP for a, b in zip(fits, fits[1:])), f"fit dropped: {fits}")
    check(launches == st.nmodes * ITERS, f"{launches} kernel launches, expected {st.nmodes * ITERS}")
    check(all(tuple(f.shape) == (s, RANK) and bool(torch.isfinite(f).all())
              for f, s in zip(state.factors, st.shape)), "factor shapes or values")
    emit({"phase": "d", "shape": list(st.shape), "nnz": st.nnz, "rank": RANK, "iters": ITERS,
          "gen_s": gen_s, "plan_build_s": plan_build_s, "decompose_s": decompose_s,
          "peak_device_bytes": torch.cuda.max_memory_allocated(), "fits": fits,
          "launches": launches, "sweep_ms": sweep_ms, "fit_ms": fit_ms,
          "kernel_ms": [x["ms"] for x in modes],
          "earlier_kernel_ms": [x["earlier_kernel_ms"] for x in modes],
          "plain_ms": [x["plain_ms"] for x in modes], "bound_ms": [x["bound_ms"] for x in modes]})

    del state
    torch.cuda.empty_cache()
    tucker, tucker_fits, tucker_sweep_ms = tucker_phases(st, gen,
                                                         ctypes.CDLL(str(earlier_libs[EARLIER_TTMC])))
    torch.cuda.empty_cache()
    tt, tt_fits, tt_sweep_ms = tt_phases(st, gen)
    torch.cuda.empty_cache()
    pms_phase(st, {"cp": fits, "tucker": tucker_fits, "tt": tt_fits},
              {"cp": sweep_ms, "tucker": tucker_sweep_ms, "tt": tt_sweep_ms}, gen)
    torch.cuda.empty_cache()
    slice_phase(st, {"cp": fits, "tucker": tucker_fits, "tt": tt_fits}, [x["ms"] for x in modes],
                torch.device("cuda", torch.cuda.current_device()))
    torch.cuda.empty_cache()
    mttkrp_entry = {
        "name": "mttkrp_blocked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mttkrp.cu",
        "replaces": "src/repro/kernels/mttkrp_pallas.py:53 _kernel",
        "launches": launches,
        "per": f"one sweep: {st.nmodes} launches, one per mode",
        "max_abs_err": max(x["max_abs_err"] for x in modes),
        "max_rel_err": max(x["max_rel_err"] for x in modes),
        "ms": sum(x["ms"] for x in modes),
        "mode_ms": [x["ms"] for x in modes],
        "earlier_kernel": str(EARLIER_MTTKRP.relative_to(ROOT)),
        "earlier_kernel_ms": sum(x["earlier_kernel_ms"] for x in modes),
        "plain_ms": sum(x["plain_ms"] for x in modes),
        "bound_ms": sum(x["bound_ms"] for x in modes),
        "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in modes) else "operations",
        "library_ms": None,
    }
    entries = {"mttkrp": mttkrp_entry, "ttmc": tucker, "ttcore": tt}
    wide_phase(st, gen, entries, {"cp": sweep_ms, "tucker": tucker_sweep_ms, "tt": tt_sweep_ms},
               {k: ctypes.CDLL(str(earlier_libs[src])) for k, src in BEFORE_WIDE.items()})
    torch.cuda.empty_cache()
    resilience_phase(st, {"cp": fits, "tucker": tucker_fits, "tt": tt_fits}, sweep_ms, gen)

    emit({"kernels": [mttkrp_entry, tucker, tt]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def tucker_phases(st, gen: torch.Generator, earlier: ctypes.CDLL) -> tuple[dict, list[float], float]:
    """Phases e and f on the NELL-2-size tensor `st`; `earlier` is the
    library of the TTMc kernel the current one replaced, timed beside it.
    Returns the TTMc kernel's entry of the `kernels` line, phase f's fits
    and the sweep's ms."""
    presets, big = [], []
    for preset, core_ranks in PRESET_CORE_RANKS.items():
        small = frostt_like(preset)
        for cfg, out in ((None, presets), (BIG_TILE, big)):
            ws = make_planned_tucker(small, core_ranks, cfg=cfg, device="cuda")
            for m, op in ws.ops.items():
                facs = random_padded(op.plan, [rank_padded(r) for r in op.in_ranks], gen)
                out.append({"preset": preset, "tile_i": op.plan.tile_i, "mode": m,
                            "in_ranks": list(op.in_ranks),
                            **check_kernel(ttmc_blocked, ttmc_blocked_plain, op.plan, facs, op.in_ranks,
                                           tol=TOL_PRESET,
                                           what=f"{preset} tile_i {op.plan.tile_i} mode {m}")})
            del ws
    wide_st = synthetic_tensor(WIDE_SHAPE, WIDE_NNZ, seed=0, skew=WIDE_SKEW)
    ws = make_planned_tucker(wide_st, WIDE_CORE_RANKS, device="cuda")
    wide = []
    for m, op in ws.ops.items():
        facs = random_padded(op.plan, [rank_padded(r) for r in op.in_ranks], gen)
        wide.append({"shape": list(WIDE_SHAPE), "core_ranks": list(WIDE_CORE_RANKS), "mode": m,
                     "in_ranks": list(op.in_ranks), "cols": op.out_cols,
                     **check_kernel(ttmc_blocked, ttmc_blocked_plain, op.plan, facs, op.in_ranks,
                                    tol=TOL_PRESET, what=f"wide TTMc mode {m}")})
    del ws

    tiny = frostt_like("tiny")
    init = init_tucker_factors(tiny.shape, PRESET_CORE_RANKS["tiny"], seed=0, device=torch.device("cuda"))
    on_gpu = decompose(tiny, PRESET_CORE_RANKS["tiny"], format="tucker", iters=3, init_factors=init,
                       device="cuda").fit_history
    on_cpu = decompose(tiny, PRESET_CORE_RANKS["tiny"], format="tucker", iters=3,
                       init_factors=[f.cpu() for f in init], device="cpu").fit_history
    fit_gap = max(abs(a - b) for a, b in zip(on_gpu, on_cpu))
    check(fit_gap <= TOL_FIT, f"tiny HOOI fits, cuda {on_gpu} vs cpu {on_cpu}")

    t0 = time.perf_counter()
    ws = make_planned_tucker(st, CORE_RANKS, device="cuda")
    torch.cuda.synchronize()
    plan_build_s = time.perf_counter() - t0
    modes = []
    for m, op in ws.ops.items():
        plan = op.plan
        facs = random_padded(plan, [rank_padded(r) for r in op.in_ranks], gen)
        errs = check_kernel(ttmc_blocked, ttmc_blocked_plain, plan, facs, op.in_ranks,
                            tol=TOL_FULL, what=f"NELL-2 TTMc mode {m}")
        bound_ms, bound_by = ttmc_bound(st.shape, st.nnz, m, CORE_RANKS)
        # The current kernel and the one it replaced in turns: now, earlier,
        # now, earlier; the least of each.
        now_ms, earlier_ms = [], []
        for _ in range(2):
            now_ms.append(cuda_ms(lambda: ttmc_blocked(plan, facs, op.in_ranks), KERNEL_REPS))
            with kernel_library("ttmc", earlier):
                earlier_ms.append(cuda_ms(lambda: ttmc_blocked(plan, facs, op.in_ranks), KERNEL_REPS))
        modes.append({
            "mode": m, "in_ranks": list(op.in_ranks), "cols": op.out_cols, **errs,
            "ms": min(now_ms), "earlier_kernel_ms": min(earlier_ms),
            "plain_ms": cuda_ms(lambda: ttmc_blocked_plain(plan, facs, op.in_ranks), TTMC_PLAIN_REPS),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        del facs
    # The sweep, and its parts timed apart on the sweep's own operands.
    norm_x_sq = torch.tensor(float((st.values.astype("float64") ** 2).sum()), device="cuda")
    facs = ws.pad_factors(init_tucker_factors(st.shape, CORE_RANKS, seed=0, device=torch.device("cuda")))
    facs, _, _ = ws.sweep(facs, norm_x_sq)
    sweep_ms = cuda_ms(lambda: ws.sweep(facs, norm_x_sq), SWEEP_REPS)
    factor_ms, ys = [], []
    for m, op in ws.ops.items():
        in_facs = [facs[im][: op.plan.in_rows[n]] for n, im in enumerate(op.plan.in_modes)]
        ys.append(ttmc_blocked(op.plan, in_facs, op.in_ranks)[: st.shape[m], : op.out_cols])
        factor_ms.append(cuda_ms(lambda: _factor_from_unfolding(ys[m], CORE_RANKS[m]), SWEEP_REPS))
    last = st.nmodes - 1
    u_last = facs[last][: st.shape[last], : CORE_RANKS[last]]
    core_fit_ms = cuda_ms(lambda: core_fit_value(
        _core_from_unfolding(ys[last], u_last, last, CORE_RANKS), norm_x_sq), SWEEP_REPS)
    kernel_ms = sum(x["ms"] for x in modes)
    del ws, op, plan, facs, in_facs, ys, u_last, norm_x_sq, init
    torch.cuda.empty_cache()
    emit({"phase": "e", "presets": presets, "wide": wide, "tile_i_8192": big,
          "tiny_fit_gap_cuda_cpu": fit_gap, "earlier_kernel": str(EARLIER_TTMC.relative_to(ROOT)),
          "nell2_core_ranks": list(CORE_RANKS), "nell2_modes": modes, "plan_build_s": plan_build_s,
          "sweep_ms": sweep_ms, "kernel_ms": kernel_ms, "factor_update_ms": factor_ms,
          "core_fit_ms": core_fit_ms,
          "rest_ms": sweep_ms - kernel_ms - sum(factor_ms) - core_fit_ms,
          "tol_preset": TOL_PRESET, "tol_full": TOL_FULL})

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = decompose(st, CORE_RANKS, format="tucker", iters=ITERS, seed=0)
    torch.cuda.synchronize()
    decompose_s = time.perf_counter() - t0
    launches = ttmc_blocked.launches
    check(mttkrp_blocked.launches == 0 and ttcore_blocked.launches == 0,
          f"HOOI launched {mttkrp_blocked.launches} MTTKRP, {ttcore_blocked.launches} TT-core kernels")
    fits = state.fit_history
    check(len(fits) == ITERS and all(math.isfinite(f) for f in fits), f"HOOI fits {fits}")
    check(all(b >= a - FIT_DROP for a, b in zip(fits, fits[1:])), f"HOOI fit dropped: {fits}")
    check(launches == st.nmodes * ITERS, f"{launches} TTMc launches, expected {st.nmodes * ITERS}")
    check(tuple(state.core.shape) == CORE_RANKS and bool(torch.isfinite(state.core).all()), "core")
    ortho = max(float((f.T @ f - torch.eye(r, device=f.device)).abs().max())
                for f, r in zip(state.factors, CORE_RANKS))
    check(all(tuple(f.shape) == (s, r) for f, s, r in zip(state.factors, st.shape, CORE_RANKS))
          and ortho <= ORTHO_TOL, f"factor shapes, or orthonormality off by {ortho}")
    emit({"phase": "f", "shape": list(st.shape), "nnz": st.nnz, "core_ranks": list(CORE_RANKS),
          "iters": ITERS, "plan_build_s": plan_build_s, "decompose_s": decompose_s,
          "peak_device_bytes": torch.cuda.max_memory_allocated(), "fits": fits,
          "factor_orthonormality_err": ortho, "launches": launches, "sweep_ms": sweep_ms,
          "kernel_ms": [x["ms"] for x in modes], "plain_ms": [x["plain_ms"] for x in modes],
          "bound_ms": [x["bound_ms"] for x in modes]})
    return {
        "name": "ttmc_blocked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ttmc.cu",
        "replaces": "src/repro/kernels/ttm_pallas.py:60 _kernel",
        "launches": launches,
        "per": f"one sweep: {st.nmodes} launches, one per mode",
        "max_abs_err": max(x["max_abs_err"] for x in modes),
        "max_rel_err": max(x["max_rel_err"] for x in modes),
        "ms": kernel_ms,
        "mode_ms": [x["ms"] for x in modes],
        "plain_ms": sum(x["plain_ms"] for x in modes),
        "bound_ms": sum(x["bound_ms"] for x in modes),
        "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in modes) else "operations",
        "library_ms": None,
    }, fits, sweep_ms


def tt_phases(st, gen: torch.Generator) -> tuple[dict, list[float], float]:
    """Phases g and h on the NELL-2-size tensor `st`; returns the TT-core
    kernel's entry of the `kernels` line, phase h's fits and the sweep's
    ms."""
    presets = []
    for preset, tt_ranks in PRESET_TT_RANKS.items():
        small = frostt_like(preset)
        ws = make_planned_tt(small, tt_ranks, device="cuda")
        for m, op in ws.ops.items():
            mats = random_padded(op.plan, [rank_padded(a * b) for a, b in op.in_rank_pairs], gen)
            presets.append({"preset": preset, "mode": m, "in_rank_pairs": list(op.in_rank_pairs),
                            **check_kernel(ttcore_blocked, ttcore_blocked_plain, op.plan, mats,
                                           op.in_rank_pairs, op.n_left, tol=TOL_PRESET,
                                           what=f"{preset} TT mode {m}")})
        del ws
    wide_st = synthetic_tensor(WIDE_SHAPE, WIDE_NNZ, seed=0, skew=WIDE_SKEW)
    ws = make_planned_tt(wide_st, WIDE_TT_RANKS, device="cuda")
    wide = []
    for m, op in ws.ops.items():
        mats = random_padded(op.plan, [rank_padded(a * b) for a, b in op.in_rank_pairs], gen)
        wide.append({"shape": list(WIDE_SHAPE), "tt_ranks": list(WIDE_TT_RANKS), "mode": m,
                     "in_rank_pairs": list(op.in_rank_pairs), "cols": op.out_cols,
                     **check_kernel(ttcore_blocked, ttcore_blocked_plain, op.plan, mats,
                                    op.in_rank_pairs, op.n_left, tol=TOL_PRESET,
                                    what=f"wide TT mode {m}")})
    del ws

    tiny = frostt_like("tiny")
    tiny_ranks = PRESET_TT_RANKS["tiny"]
    init = init_tt_cores(tiny.shape, tiny_ranks, seed=0, device=torch.device("cuda"))
    on_gpu = decompose(tiny, tiny_ranks, format="tt", iters=3, init_factors=init,
                       device="cuda").fit_history
    on_cpu = decompose(tiny, tiny_ranks, format="tt", iters=3, init_factors=[c.cpu() for c in init],
                       device="cpu").fit_history
    fit_gap = max(abs(a - b) for a, b in zip(on_gpu, on_cpu))
    check(fit_gap <= TOL_FIT, f"tiny TT-ALS fits, cuda {on_gpu} vs cpu {on_cpu}")

    t0 = time.perf_counter()
    ws = make_planned_tt(st, TT_RANKS, device="cuda")
    torch.cuda.synchronize()
    plan_build_s = time.perf_counter() - t0
    modes = []
    for m, op in ws.ops.items():
        plan = op.plan
        mats = random_padded(plan, [rank_padded(a * b) for a, b in op.in_rank_pairs], gen)
        errs = check_kernel(ttcore_blocked, ttcore_blocked_plain, plan, mats, op.in_rank_pairs,
                            op.n_left, tol=TOL_FULL, what=f"NELL-2 TT-core mode {m}")
        bound_ms, bound_by = ttcore_bound(st.shape, st.nnz, m, TT_RANKS)
        modes.append({
            "mode": m, "in_rank_pairs": list(op.in_rank_pairs), "cols": op.out_cols, **errs,
            "ms": cuda_ms(lambda: ttcore_blocked(plan, mats, op.in_rank_pairs, op.n_left),
                          KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: ttcore_blocked_plain(plan, mats, op.in_rank_pairs, op.n_left),
                                TTMC_PLAIN_REPS),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        del mats
    # The sweep, and its parts timed apart on the sweep's own operands.
    idx = torch.from_numpy(st.indices).cuda()
    val = torch.from_numpy(st.values).cuda()
    norm_x_sq = torch.tensor(float((st.values.astype("float64") ** 2).sum()), device="cuda")
    facs = ws.pad_factors([core_to_matrix(c) for c in
                           init_tt_cores(st.shape, TT_RANKS, seed=0, device=torch.device("cuda"))])
    facs, _, _ = ws.sweep(facs, idx, val, norm_x_sq)
    sweep_ms = cuda_ms(lambda: ws.sweep(facs, idx, val, norm_x_sq), SWEEP_REPS)
    pairs, lr = ws.bond_pairs, ws.lane_ranks
    cores = [matrix_to_core(f[:s, :w], *pr) for f, s, w, pr in zip(facs, st.shape, lr, pairs)]
    bs = []
    for m, op in ws.ops.items():
        in_mats = [facs[im][: op.plan.in_rows[n]] for n, im in enumerate(op.plan.in_modes)]
        bs.append(ttcore_blocked(op.plan, in_mats, op.in_rank_pairs, op.n_left)[: st.shape[m], : lr[m]])

    def solves_and_grams():
        qs = _q_suffix(cores)
        p = torch.ones((1, 1), device="cuda")
        for m in range(st.nmodes):
            _solve_core(torch.kron(p, qs[m]), bs[m])
            p = _p_next(p, cores[m])
        return p

    solve_gram_ms = cuda_ms(solves_and_grams, SWEEP_REPS)
    p_last = solves_and_grams()
    fit_ms = cuda_ms(lambda: _fit_from(norm_x_sq, p_last[0, 0], tt_inner(idx, val, cores)), SWEEP_REPS)
    kernel_ms = sum(x["ms"] for x in modes)
    del ws, op, plan, facs, in_mats, bs, cores, p_last, idx, val, norm_x_sq, init
    torch.cuda.empty_cache()
    emit({"phase": "g", "presets": presets, "wide": wide, "tiny_fit_gap_cuda_cpu": fit_gap,
          "nell2_tt_ranks": list(TT_RANKS), "nell2_modes": modes, "plan_build_s": plan_build_s,
          "sweep_ms": sweep_ms, "kernel_ms": kernel_ms, "solve_gram_ms": solve_gram_ms,
          "fit_ms": fit_ms, "rest_ms": sweep_ms - kernel_ms - solve_gram_ms - fit_ms,
          "tol_preset": TOL_PRESET, "tol_full": TOL_FULL})

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = decompose(st, TT_RANKS, format="tt", iters=ITERS, init="random", seed=0)
    torch.cuda.synchronize()
    decompose_s = time.perf_counter() - t0
    launches = ttcore_blocked.launches
    check(mttkrp_blocked.launches == 0 and ttmc_blocked.launches == 0,
          f"TT-ALS launched {mttkrp_blocked.launches} MTTKRP, {ttmc_blocked.launches} TTMc kernels")
    fits = state.fit_history
    check(len(fits) == ITERS and all(math.isfinite(f) for f in fits), f"TT-ALS fits {fits}")
    check(fits[-1] > fits[0], f"TT-ALS fit did not rise: {fits}")
    check(launches == st.nmodes * ITERS, f"{launches} TT-core launches, expected {st.nmodes * ITERS}")
    want = [(a, s, b) for s, (a, b) in zip(st.shape, _tt_bond_pairs(TT_RANKS, st.nmodes))]
    check([tuple(c.shape) for c in state.cores] == want
          and all(bool(torch.isfinite(c).all()) for c in state.cores), "TT core shapes or values")
    emit({"phase": "h", "shape": list(st.shape), "nnz": st.nnz, "tt_ranks": list(TT_RANKS),
          "iters": ITERS, "init": "random", "plan_build_s": plan_build_s,
          "decompose_s": decompose_s, "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "fits": fits, "max_fit_drop": max(a - b for a, b in zip(fits, fits[1:])),
          "launches": launches, "sweep_ms": sweep_ms, "kernel_ms": [x["ms"] for x in modes],
          "solve_gram_ms": solve_gram_ms, "fit_ms": fit_ms,
          "plain_ms": [x["plain_ms"] for x in modes], "bound_ms": [x["bound_ms"] for x in modes]})
    return {
        "name": "ttcore_blocked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ttcore.cu",
        "replaces": "src/repro/kernels/tt_pallas.py:72 _kernel",
        "launches": launches,
        "per": f"one sweep: {st.nmodes} launches, one per mode",
        "max_abs_err": max(x["max_abs_err"] for x in modes),
        "max_rel_err": max(x["max_rel_err"] for x in modes),
        "ms": kernel_ms,
        "mode_ms": [x["ms"] for x in modes],
        "plain_ms": sum(x["plain_ms"] for x in modes),
        "bound_ms": sum(x["bound_ms"] for x in modes),
        "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in modes) else "operations",
        "library_ms": None,
    }, fits, sweep_ms


def cfg_label(cfg: MemoryControllerConfig) -> list[int]:
    c = cfg.cache
    return [c.tile_i, c.tile_j, c.tile_k, cfg.dma.blk]


def spearman(a: list[float], b: list[float]) -> float:
    """Spearman's rank correlation (Pearson's on ranks; ties take their
    average rank)."""

    def ranks(x):
        order = sorted(range(len(x)), key=lambda i: x[i])
        r = [0.0] * len(x)
        k = 0
        while k < len(order):
            j = k
            while j + 1 < len(order) and x[order[j + 1]] == x[order[k]]:
                j += 1
            for t in range(k, j + 1):
                r[order[t]] = (k + j) / 2
            k = j + 1
        return r

    ra, rb = ranks(a), ranks(b)
    ma, mb = sum(ra) / len(ra), sum(rb) / len(rb)
    cov = sum((x - ma) * (y - mb) for x, y in zip(ra, rb))
    var = math.sqrt(sum((x - ma) ** 2 for x in ra) * sum((y - mb) ** 2 for y in rb))
    return cov / var if var else float("nan")


def check_exact(kernel, plain, plan, facs, *extra, what: str) -> float:
    """Kernel vs its plain version in float64 on the same inputs (phase c's
    full-size tolerance); returns the error relative to each column's max."""
    ker = kernel(plan, facs, *extra)
    exact = plain(dataclasses.replace(plan, vals=plan.vals.double()), [f.double() for f in facs], *extra)
    _, rel_err = errors(ker, exact)
    del ker, exact
    check(rel_err <= TOL_FULL, f"{what}: kernel rel err {rel_err} > {TOL_FULL}")
    return rel_err


def pms_phase(st, main_fits: dict, main_sweep_ms: dict, gen: torch.Generator) -> None:
    """Phase i on the NELL-2-size tensor `st`: the PMS's search, its picks
    held to the plain versions and timed against its predictions beside the
    default, its last-ranked and every tile at 1,024, the auto-tuned
    decompositions against phases d, f and h (`main_fits`, and their sweeps
    `main_sweep_ms`), a warm autotune cache, and the calibration of the
    PMS's rates."""
    spec = GPUSpec()
    phase_t0 = t0 = time.perf_counter()
    hs = hg_stats(st)
    stats_s = time.perf_counter() - t0
    kernels = {"mttkrp": (RANK, None), "ttmc": (RANK, CORE_RANKS), "tt": (RANK, TT_RANKS)}
    searches, picks, last = [], {}, {}
    for kernel, (rank, ranks) in kernels.items():
        for m in range(st.nmodes):
            metrics.reset()
            t0 = time.perf_counter()
            ranked = pms.search(hs, m, rank, spec=spec, kernel=kernel, core_ranks=ranks, top_k=256)
            search_s = time.perf_counter() - t0
            scored = metrics.snapshot()["counters"][
                f"pms.configs_evaluated{{kernel={kernel},sharded=false}}"]
            picks[kernel, m] = [e.cfg for e in ranked[:PMS_TIMED]]
            last[kernel, m] = [e.cfg for e in ranked if e.nblocks * e.cfg.dma.blk <= PMS_MAX_SLOTS
                               ][-PMS_LAST:]
            searches.append({"kernel": kernel, "mode": m, "search_s": search_s, "scored": scored,
                             "top": [{"cfg": cfg_label(e.cfg), "predicted_ms": e.t_total * 1e3,
                                      "smem_bytes": e.smem_bytes, "row_parts": e.row_parts}
                                     for e in ranked[:PMS_LISTED]]})

    # Each kernel at the top configurations, the default, the last-ranked
    # and every tile at 1,024: timed and set beside the exact prediction
    # and each of its terms; the picks and the default also held to the
    # float64 plain version; the first pick timed in turns with the default.
    default_cfg = MemoryControllerConfig()
    timed = []
    for kernel, modes in PMS_MODES.items():
        rank, ranks = kernels[kernel]
        for m in modes:
            cfgs = []
            for cfg in picks[kernel, m] + [default_cfg] + last[kernel, m] + [PMS_ALL_1024]:
                if cfg not in cfgs:
                    cfgs.append(cfg)
            rows, kept = [], {}
            for cfg in cfgs:
                what = f"{kernel} mode {m} at {cfg_label(cfg)}"
                if kernel == "mttkrp":
                    op = make_planned_mttkrp(st, m, rank, cfg=cfg, device="cuda")
                    facs = random_padded(op.plan, [rank_padded(rank)] * op.plan.n_in, gen)
                    args = (mttkrp_blocked, mttkrp_blocked_plain, op.plan, facs)
                    est = pms.predict_from_plan(op.plan, rank, cfg, spec)
                elif kernel == "ttmc":
                    op = make_planned_ttmc(st, m, ranks, cfg=cfg, device="cuda")
                    facs = random_padded(op.plan, [rank_padded(r) for r in op.in_ranks], gen)
                    args = (ttmc_blocked, ttmc_blocked_plain, op.plan, facs, op.in_ranks)
                    est = pms.predict_ttmc(op.plan, ranks, cfg, spec)
                else:
                    op = make_planned_ttcore(st, m, ranks, cfg=cfg, device="cuda")
                    facs = random_padded(op.plan, [rank_padded(a * b) for a, b in op.in_rank_pairs], gen)
                    args = (ttcore_blocked, ttcore_blocked_plain, op.plan, facs, op.in_rank_pairs, op.n_left)
                    est = pms.predict_tt(op.plan, ranks, cfg, spec)
                checked = cfg == default_cfg or cfg in picks[kernel, m]
                rel_err = check_exact(*args, what=what) if checked else None
                ker, _, plan, *rest = args
                ms = cuda_ms(lambda: ker(plan, *rest), KERNEL_REPS)
                role = ("pick" if cfg in picks[kernel, m] else "default" if cfg == default_cfg
                        else "last" if cfg in last[kernel, m] else "all_1024")
                rows.append({"cfg": cfg_label(cfg), "role": role, "nblocks": plan.nblocks,
                             "padding": plan.padding_fraction(), "predicted_ms": est.t_total * 1e3,
                             **{f"{t}_ms": getattr(est, t) * 1e3 for t in (
                                 "t_stream", "t_reread", "t_factor", "t_out", "t_gather",
                                 "t_flush", "t_compute")},
                             "occupancy": est.occupancy, "step_share": est.step_share,
                             "wave_share": est.wave_share, "ms": ms,
                             "achieved_share": est.t_total * 1e3 / ms, "smem_bytes": est.smem_bytes,
                             "row_parts": est.row_parts, "col_slices": est.col_slices,
                             "max_rel_err": rel_err})
                if cfg in (default_cfg, picks[kernel, m][0]):
                    kept[cfg] = lambda ker=ker, plan=plan, rest=rest: ker(plan, *rest)
                del op, facs, args, plan, rest, ker
                torch.cuda.empty_cache()
            turns = {"pick": [], "default": []}
            for turn in PICK_TURNS:
                turns[turn].append(cuda_ms(kept[picks[kernel, m][0] if turn == "pick" else default_cfg],
                                           KERNEL_REPS))
            del kept
            torch.cuda.empty_cache()
            pick_over_default = min(turns["pick"]) / min(turns["default"])
            spread = max(r["ms"] for r in rows) / min(r["ms"] for r in rows)
            rho = spearman([r["predicted_ms"] for r in rows], [r["ms"] for r in rows])
            check(pick_over_default <= PICK_SLOWDOWN,
                  f"{kernel} mode {m}: the first pick {cfg_label(picks[kernel, m][0])} runs "
                  f"{pick_over_default} of the default in turns")
            check(spread <= PMS_SPREAD or rho >= PMS_SPEARMAN_MIN,
                  f"{kernel} mode {m}: Spearman {rho} over times that spread {spread}")
            timed.append({"kernel": kernel, "mode": m, "configs": rows, "spearman": rho,
                          "spread": spread, "turns": list(PICK_TURNS), "pick_ms": turns["pick"],
                          "default_ms": turns["default"], "pick_over_default": pick_over_default})

    # decompose(..., auto_tune=True) for every format: the workspace it
    # builds (plan build, picks, sweep), then the call itself.
    formats = {"cp": (RANK, {}, "d"), "tucker": (CORE_RANKS, {}, "f"),
               "tt": (TT_RANKS, {"init": "random"}, "h")}
    make_planned = {"cp": make_planned_cp_als, "tucker": make_planned_tucker, "tt": make_planned_tt}
    counters = {"cp": mttkrp_blocked, "tucker": ttmc_blocked, "tt": ttcore_blocked}
    norm_x_sq = torch.tensor(float((st.values.astype("float64") ** 2).sum()), device="cuda")
    tuned = []
    for fmt, (rank, extra, phase) in formats.items():
        t0 = time.perf_counter()
        ws = make_planned[fmt](st, rank, auto_tune=True, device="cuda")
        torch.cuda.synchronize()
        plan_build_s = time.perf_counter() - t0
        chosen = [cfg_label(ws.ops[m].cfg) for m in range(st.nmodes)]
        if fmt == "tucker":
            init = init_tucker_factors(st.shape, rank, seed=0, device=torch.device("cuda"))
            args = (norm_x_sq,)
        else:
            if fmt == "cp":
                init = [torch.randn((s, rank), generator=gen, device="cuda") / math.sqrt(rank)
                        for s in st.shape]
            else:
                init = [core_to_matrix(c) for c in
                        init_tt_cores(st.shape, rank, seed=0, device=torch.device("cuda"))]
            args = (torch.from_numpy(st.indices).cuda(), torch.from_numpy(st.values).cuda(), norm_x_sq)
        facs = ws.pad_factors(init)
        # The tuned sweep in turns with one at the default geometry, from
        # the same factors; it may not be slower than the default beyond
        # the default's own spread (these turns and phase d, f or h).
        base = make_planned[fmt](st, rank, device="cuda")
        base_facs = base.pad_factors(init)
        facs, _, _ = ws.sweep(facs, *args, first=True)
        base_facs, _, _ = base.sweep(base_facs, *args, first=True)
        turns = {"default": [], "tuned": []}
        for turn in SWEEP_TURNS:
            turns[turn].append(cuda_ms(lambda: ws.sweep(facs, *args), SWEEP_REPS) if turn == "tuned"
                               else cuda_ms(lambda: base.sweep(base_facs, *args), SWEEP_REPS))
        sweep_ms = min(turns["tuned"])
        defaults = turns["default"] + [main_sweep_ms[fmt]]
        check(sweep_ms <= max(defaults),
              f"auto-tuned {fmt} sweep {turns['tuned']} ms against the default's {defaults}")
        del ws, base, facs, base_facs, args, init
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = decompose(st, rank, format=fmt, iters=ITERS, seed=0, auto_tune=True, **extra)
        torch.cuda.synchronize()
        decompose_s = time.perf_counter() - t0
        launches = counters[fmt].launches
        check(sum(c.launches for c in counters.values()) == launches == st.nmodes * ITERS,
              f"auto-tuned {fmt}: {launches} launches of its kernel, expected {st.nmodes * ITERS}")
        fits = state.fit_history
        gap = max(abs(a - b) for a, b in zip(fits, main_fits[fmt]))
        check(len(fits) == ITERS and all(math.isfinite(f) for f in fits) and gap <= TOL_TUNED_FIT,
              f"auto-tuned {fmt} fits {fits} against phase {phase}'s {main_fits[fmt]}")
        tuned.append({"format": fmt, "ranks": rank, "chosen": chosen, "plan_build_s": plan_build_s,
                      "sweep_ms": sweep_ms, "turns": list(SWEEP_TURNS),
                      "tuned_sweep_ms": turns["tuned"], "default_sweep_ms": turns["default"],
                      f"phase_{phase}_sweep_ms": main_sweep_ms[fmt],
                      "default_spread_ms": max(defaults) - min(defaults),
                      "tuned_over_default": sweep_ms / min(turns["default"]),
                      "decompose_s": decompose_s,
                      "peak_device_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
                      "fits": fits, f"phase_{phase}_fits": main_fits[fmt], "max_fit_gap": gap})
        del state
        torch.cuda.empty_cache()

    # A warm autotune cache: the second auto_tune="cached" call evaluates
    # no configuration and takes the first one's picks, which the cache
    # holds as the search's own; its fit is the first's up to the kernel's
    # float32 sum order (ranges' partial sums land in a varying order).
    def missed():
        raise RuntimeError("chip_smoke check failed: the warm autotune cache missed")

    with tempfile.TemporaryDirectory() as cache_dir:
        before = os.environ.get("REPRO_TORCH_AUTOTUNE_DIR")
        os.environ["REPRO_TORCH_AUTOTUNE_DIR"] = cache_dir
        try:
            cached = []
            for _ in range(2):
                metrics.reset()
                state = decompose(st, RANK, format="cp", iters=1, seed=0, auto_tune="cached")
                snap = metrics.snapshot()["counters"]
                cached.append({"fit": state.fit_history[0],
                               "configs_evaluated": sum(v for k, v in snap.items()
                                                        if k.startswith("pms.configs_evaluated")),
                               "cache_hits": sum(v for k, v in snap.items()
                                                 if k.startswith("autotune_cache.hits"))})
                del state
                torch.cuda.empty_cache()
            held = [cached_config("mttkrp", st.fingerprint(), m, RANK, spec, missed)
                    for m in range(st.nmodes)]
        finally:
            if before is None:
                del os.environ["REPRO_TORCH_AUTOTUNE_DIR"]
            else:
                os.environ["REPRO_TORCH_AUTOTUNE_DIR"] = before
    check(cached[0]["configs_evaluated"] == 256 * st.nmodes and cached[1]["configs_evaluated"] == 0
          and cached[1]["cache_hits"] == st.nmodes
          and held == [picks["mttkrp", m][0] for m in range(st.nmodes)]
          and abs(cached[1]["fit"] - cached[0]["fit"]) <= TOL_FIT,
          f"autotune cache: {cached}, held {[cfg_label(c) for c in held]}")
    cached.append({"held": [cfg_label(c) for c in held],
                   "fit_gap": abs(cached[1]["fit"] - cached[0]["fit"])})

    # Calibration: the card's rates, and the block-sweep fit of the PMS's.
    bw = measure_hbm_bw()
    pf = measure_peak_flops_f32()
    samples = []
    for cfg in DEFAULT_CALIBRATION_CFGS:
        samples.append(sweep_sample(st, RANK, cfg, reps=SWEEP_REPS))
        torch.cuda.empty_cache()
    fitted = fit_spec(samples, spec, fallback_hbm_bw=bw, fallback_peak_flops=pf)
    calib = {"measured_hbm_bw": bw, "measured_peak_flops_f32": pf,
             "datasheet_hbm_bw": spec.hbm_bw, "datasheet_peak_flops_f32": spec.peak_flops_f32,
             "fitted_hbm_bw": fitted.hbm_bw, "fitted_peak_flops_f32": fitted.peak_flops_f32,
             "samples": [{"cfg": s.label, "sweep_ms": s.measured_s * 1e3, "bytes": s.mem_bytes,
                          "l2_bytes": s.l2_bytes, "flops": s.flops,
                          "predicted_ms_datasheet": predicted_seconds(s.per_mode, spec) * 1e3,
                          "predicted_ms_fitted": predicted_seconds(s.per_mode, fitted) * 1e3}
                         for s in samples]}
    emit({"phase": "i", "nvidia_smi": nvidia_smi(), "phase_s": time.perf_counter() - phase_t0,
          "stats_s": stats_s, "searches": searches,
          "timed": timed, "auto_tuned": tuned, "cached": cached, "calibration": calib,
          "tol_full": TOL_FULL, "tol_tuned_fit": TOL_TUNED_FIT})


def exact_mttkrp(idx, val, facs, mode: int, rows: int) -> torch.Tensor:
    """MTTKRP in float64 over the raw stream, EXACT_CHUNK non-zeros a step
    (float64 atomics: a reference whose own rounding is negligible)."""
    out = torch.zeros((rows, facs[0].shape[1]), dtype=torch.float64, device=val.device)
    f64 = [f.double() for f in facs]
    for z0 in range(0, val.shape[0], EXACT_CHUNK):
        i = idx[z0: z0 + EXACT_CHUNK]
        out.index_add_(0, i[:, mode], hadamard_rows(i, val[z0: z0 + EXACT_CHUNK].double(), f64, mode))
    return out


def host_s(fn):
    """(result, seconds) of fn() ending in a synchronize, by the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def slice_phase(st, main_fits: dict, planned_ms: list[float], dev: torch.device) -> None:
    """Phase j on the NELL-2-size tensor `st`, on the card `dev`: the
    Tensor Remapper, the compute patterns beside the planned kernel
    (`planned_ms`, phase c), CP-ALS by approach 1 and 2 on both layouts
    (fits against phase d's in `main_fits`), Tucker and TT
    method="reference", and the one-shot dispatchers with their plan
    cache."""
    phase_t0 = time.perf_counter()
    nm, shape = st.nmodes, st.shape
    idx, val = to_device(st, dev)

    # The Remapper on the stream as generated: the stable sort against the
    # radix passes of at most POINTER_BUDGET bins.
    remap = []
    for m in range(nm):
        a = remap_stable(idx, val, m)
        b = remap_radix(idx, val, m, shape[m], POINTER_BUDGET)
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        check(equal, f"remap_radix's order differs from remap_stable's on mode {m}")
        del a, b
        remap.append({"mode": m, "nbins": shape[m], "passes": radix_digits(shape[m], POINTER_BUDGET),
                      "stable_ms": cuda_ms(lambda: remap_stable(idx, val, m), PATTERN_REPS),
                      "radix_ms": cuda_ms(lambda: remap_radix(idx, val, m, shape[m], POINTER_BUDGET),
                                          PATTERN_REPS),
                      "orders_equal": equal})

    # The compute patterns per mode, on the stream sorted by the mode, from
    # phase d's initial factors; the remap from the previous mode's order.
    facs = _initial_factors(st, RANK, None, 0, dev)
    streams = [remap_stable(idx, val, m)[:2] for m in range(nm)]
    table = []
    for m in range(nm):
        i, v = streams[m]
        exact = exact_mttkrp(i, v, facs, m, shape[m])
        row = {"mode": m, "planned_ms": planned_ms[m],
               "remap_ms": cuda_ms(lambda: remap_stable(*streams[m - 1], m), PATTERN_REPS),
               "approach1_model_bytes": approach1_traffic(st, m, RANK).bytes(),
               "approach2_model_bytes": approach2_traffic(st, m, RANK).bytes()}
        for method in PATTERNS:
            got = mttkrp(i, v, facs, m, shape[m], method=method)
            row[f"{method}_max_rel_err"] = errors(got, exact)[1]
            del got
            row[f"{method}_ms"] = cuda_ms(lambda: mttkrp(i, v, facs, m, shape[m], method=method),
                                          PATTERN_REPS)
        table.append(row)
        del exact
    norm_x_sq = torch.tensor(float((st.values.astype("float64") ** 2).sum()), device=dev)
    sweeps = {}
    for method in PATTERNS:
        for layout in LAYOUTS:
            kw = dict(shape=shape, method=method, first=False)
            if layout == "copies":
                sweeps[method, layout] = cuda_ms(lambda: _sweep_streams(facs, streams, norm_x_sq, **kw),
                                                 SWEEP_REPS)
            else:  # the carried stream is sorted by the last mode
                sweeps[method, layout] = cuda_ms(lambda: _sweep_remap(facs, *streams[-1], norm_x_sq, **kw),
                                                 SWEEP_REPS)
    del streams, idx, val, facs, norm_x_sq
    torch.cuda.empty_cache()

    # CP-ALS by each pattern and layout, as a user calls it.
    runs = []
    for method in PATTERNS:
        for layout in LAYOUTS:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            state, decompose_s = host_s(lambda: decompose(st, RANK, method=method, layout=layout,
                                                          iters=ITERS, seed=0, device=dev))
            fits = state.fit_history
            launched = mttkrp_blocked.launches + ttmc_blocked.launches + ttcore_blocked.launches
            check(launched == 0, f"{method}/{layout} launched {launched} kernels")
            check(len(fits) == ITERS and all(math.isfinite(f) for f in fits)
                  and all(b >= a - FIT_DROP for a, b in zip(fits, fits[1:])),
                  f"{method}/{layout} fits {fits}")
            gap = max(abs(a - b) for a, b in zip(fits, main_fits["cp"]))
            check(gap <= TOL_TUNED_FIT, f"{method}/{layout} fits {fits} against phase d's {main_fits['cp']}")
            runs.append({"method": method, "layout": layout, "sweep_ms": sweeps[method, layout],
                         "decompose_s": decompose_s,
                         "peak_device_bytes": torch.cuda.max_memory_allocated(), "fits": fits,
                         "max_fit_gap_phase_d": gap})
            del state
            torch.cuda.empty_cache()

    # Tucker and TT by their reference methods: one iteration and two, the
    # difference one sweep.
    reference = []
    for fmt, ranks, extra, phase in (("tucker", CORE_RANKS, {}, "f"),
                                     ("tt", TT_RANKS, {"init": "random"}, "h")):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        one, one_s = host_s(lambda: decompose(st, ranks, format=fmt, method="reference", iters=1,
                                              seed=0, device=dev, **extra))
        del one
        state, two_s = host_s(lambda: decompose(st, ranks, format=fmt, method="reference",
                                                iters=REF_ITERS, seed=0, device=dev, **extra))
        fits = state.fit_history
        launched = mttkrp_blocked.launches + ttmc_blocked.launches + ttcore_blocked.launches
        check(launched == 0, f"{fmt} reference launched {launched} kernels")
        check(len(fits) == REF_ITERS and all(math.isfinite(f) for f in fits)
              and all(b >= a - FIT_DROP for a, b in zip(fits, fits[1:])), f"{fmt} reference fits {fits}")
        check(fmt != "tt" or fits[-1] > fits[0], f"TT reference fit did not rise: {fits}")
        reference.append({"format": fmt, "ranks": list(ranks), "iters": REF_ITERS,
                          "sweep_ms": (two_s - one_s) * 1e3, "decompose_s": two_s,
                          "peak_device_bytes": torch.cuda.max_memory_allocated(), "fits": fits,
                          f"phase_{phase}_fits": main_fits[fmt][:REF_ITERS],
                          "max_fit_gap": max(abs(a - b) for a, b in zip(fits, main_fits[fmt]))})
        del state
        torch.cuda.empty_cache()

    # The one-shot dispatchers: a plan-cache miss, then a hit.
    plan_cache_clear()
    reset_launches()
    idx, val = to_device(st, dev)
    facs = _initial_factors(st, RANK, None, 0, dev)
    first, first_s = host_s(lambda: mttkrp_auto(st, facs, 0, device=dev))
    second, second_s = host_s(lambda: mttkrp_auto(st, facs, 0, device=dev))
    stats = plan_cache_stats()
    check(mttkrp_blocked.launches == 2 and stats["by_kind"]["mttkrp"] == {"hits": 1, "misses": 1},
          f"mttkrp_auto: {mttkrp_blocked.launches} launches, cache {stats}")
    exact = exact_mttkrp(idx, val, facs, 0, shape[0])
    mttkrp_err = max(errors(first, exact)[1], errors(second, exact)[1])
    check(mttkrp_err <= TOL_FULL, f"mttkrp_auto rel err {mttkrp_err} > {TOL_FULL}")
    del first, second, exact
    tfacs = init_tucker_factors(shape, CORE_RANKS, seed=0, device=dev)
    y, tucker_s = host_s(lambda: tucker_auto(st, tfacs, 0, device=dev))
    tucker_err = errors(y, ttmc_ref(idx, val.double(), [f.double() for f in tfacs], 0, shape[0]))[1]
    check(ttmc_blocked.launches == 1 and tucker_err <= TOL_FULL,
          f"tucker_auto: {ttmc_blocked.launches} launches, rel err {tucker_err}")
    del y
    cores = init_tt_cores(shape, TT_RANKS, seed=0, device=dev)
    b, tt_s = host_s(lambda: tt_auto(st, cores, 0, device=dev))
    tt_err = errors(b, ttcore_ref(idx, val.double(), [c.double() for c in cores], 0, shape[0]))[1]
    check(ttcore_blocked.launches == 1 and tt_err <= TOL_FULL,
          f"tt_auto: {ttcore_blocked.launches} launches, rel err {tt_err}")
    dispatch = {"mttkrp_auto_first_s": first_s, "mttkrp_auto_second_s": second_s,
                "mttkrp_auto_max_rel_err": mttkrp_err, "tucker_auto_s": tucker_s,
                "tucker_auto_max_rel_err": tucker_err, "tt_auto_s": tt_s, "tt_auto_max_rel_err": tt_err,
                "plan_cache_stats": plan_cache_stats(),
                "launches": {"mttkrp_blocked": mttkrp_blocked.launches,
                             "ttmc_blocked": ttmc_blocked.launches,
                             "ttcore_blocked": ttcore_blocked.launches}}
    del b, idx, val, facs, tfacs, cores
    plan_cache_clear()  # no 1.7 GB plan outlives the phase
    torch.cuda.empty_cache()
    emit({"phase": "j", "nvidia_smi": nvidia_smi(), "phase_s": time.perf_counter() - phase_t0,
          "rank": RANK, "iters": ITERS, "pointer_budget": POINTER_BUDGET, "remap": remap,
          "mttkrp_per_mode": table, "cp_runs": runs, "reference": reference, "dispatch": dispatch,
          "tol_full": TOL_FULL, "tol_fit_gap": TOL_TUNED_FIT})


def wide_mode_kernels(n_in: int, gen: torch.Generator) -> dict:
    """Phase k's fault F3 part on the tensor of WIDE_MODE_TENSORS[n_in]:
    each kernel's wide path held to its float64 plain version on every mode
    and timed beside its bound, then decompose for WIDE_MODE_ITERS
    iterations on the same workspace with the launch counters read (CP:
    fits never drop; Tucker: factors orthonormal; TT: finite fits)."""
    t0 = time.perf_counter()
    shape, nnz = WIDE_MODE_TENSORS[n_in]
    st = synthetic_tensor(shape, nnz, seed=0, skew=WIDE_MODE_SKEW)
    n, iters = st.nmodes, WIDE_MODE_ITERS
    core_ranks, tt_ranks = (WIDE_MODE_RANK,) * n, (WIDE_MODE_RANK,) * (n - 1)
    out = {"n_in": n_in, "shape": list(shape), "nnz": st.nnz, "skew": WIDE_MODE_SKEW}

    def mode_row(m, plan, call, bound_at, what, *check_args):
        rel = check_exact(*check_args, what=what)
        bound_ms, bound_by = bound_at
        return {"mode": m, "nblocks": plan.nblocks, "padding": plan.padding_fraction(),
                "max_rel_err": rel, "ms": cuda_ms(call, WIDE_MODE_REPS), "bound_ms": bound_ms,
                "bound_by": bound_by}

    def run(fmt, rank, ws, kernel, **kw):
        reset_launches()
        state = decompose(st, rank, format=fmt, iters=iters, seed=0, planned=ws, device=ws.device, **kw)
        torch.cuda.synchronize()
        fits = state.fit_history
        launches = {k.__name__: k.launches for k in (mttkrp_blocked, ttmc_blocked, ttcore_blocked)}
        check(launches[kernel.__name__] == n * iters and sum(launches.values()) == n * iters,
              f"{n}-mode {fmt}: launches {launches}, expected {n * iters} of {kernel.__name__}")
        check(len(fits) == iters and all(math.isfinite(f) for f in fits), f"{n}-mode {fmt} fits {fits}")
        return state, {"fits": fits, "launches": launches[kernel.__name__]}

    ws = make_planned_cp_als(st, RANK, device="cuda")
    rows = []
    for m in range(n):
        plan = ws.plan_for(m)
        facs = random_padded(plan, [rank_padded(RANK)] * plan.n_in, gen)
        rows.append(mode_row(m, plan, lambda: mttkrp_blocked(plan, facs), bound(st.shape, st.nnz, m, RANK),
                             f"{n}-mode MTTKRP mode {m}", mttkrp_blocked, mttkrp_blocked_plain, plan, facs))
    del plan, facs
    state, cp = run("cp", RANK, ws, mttkrp_blocked)
    check(all(b >= a - FIT_DROP for a, b in zip(cp["fits"], cp["fits"][1:])),
          f"{n}-mode CP fit dropped: {cp['fits']}")
    out["mttkrp"] = {"rank": RANK, "modes": rows, "cp": cp}
    del ws, state
    torch.cuda.empty_cache()

    ws = make_planned_tucker(st, core_ranks, device="cuda")
    rows = []
    for m, op in ws.ops.items():
        facs = random_padded(op.plan, [rank_padded(r) for r in op.in_ranks], gen)
        rows.append({"cols": op.out_cols, **mode_row(
            m, op.plan, lambda: ttmc_blocked(op.plan, facs, op.in_ranks),
            ttmc_bound(st.shape, st.nnz, m, core_ranks), f"{n}-mode TTMc mode {m}",
            ttmc_blocked, ttmc_blocked_plain, op.plan, facs, op.in_ranks)})
    del op, facs
    state, tucker = run("tucker", core_ranks, ws, ttmc_blocked)
    ortho = max(float((f.T @ f - torch.eye(r, device=f.device)).abs().max())
                for f, r in zip(state.factors, core_ranks))
    check(ortho <= ORTHO_TOL, f"{n}-mode Tucker factors off orthonormal by {ortho}")
    out["ttmc"] = {"core_ranks": list(core_ranks), "modes": rows,
                   "tucker": {**tucker, "factor_orthonormality_err": ortho}}
    del ws, state
    torch.cuda.empty_cache()

    ws = make_planned_tt(st, tt_ranks, device="cuda")
    rows = []
    for m, op in ws.ops.items():
        mats = random_padded(op.plan, [rank_padded(a * b) for a, b in op.in_rank_pairs], gen)
        rows.append({"cols": op.out_cols, **mode_row(
            m, op.plan, lambda: ttcore_blocked(op.plan, mats, op.in_rank_pairs, op.n_left),
            ttcore_bound(st.shape, st.nnz, m, tt_ranks), f"{n}-mode TT-core mode {m}",
            ttcore_blocked, ttcore_blocked_plain, op.plan, mats, op.in_rank_pairs, op.n_left)})
    del op, mats
    state, tt = run("tt", tt_ranks, ws, ttcore_blocked, init="random")
    out["ttcore"] = {"tt_ranks": list(tt_ranks), "modes": rows, "tt": tt}
    del ws, state
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


# Phase k's traced runs: each format's rank, its decompose options, its
# drive label, its kernel and its workspace builder.
TRACED = {
    "cp": (RANK, {}, "cp_als", mttkrp_blocked, make_planned_cp_als),
    "tucker": (CORE_RANKS, {}, "tucker_hooi", ttmc_blocked, make_planned_tucker),
    "tt": (TT_RANKS, {"init": "random"}, "tt_als", ttcore_blocked, make_planned_tt),
}


def traced_runs(st, main_sweep_ms: dict) -> list[dict]:
    """decompose(..., trace=path) for each format on the NELL-2-size tensor:
    the span counts and nesting, the steady sweep spans against the sweep
    times of phases d, f and h, join_trace's row; then on one workspace the
    sweep with tracing on and off in turns (TRACE_TURNS), each drive's
    steady sweeps timed by its `drive.iter_seconds` series."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for fmt, (rank, kw, label, kernel, build_ws) in TRACED.items():
            path = Path(tmp) / f"{fmt}.jsonl"
            reset_launches()
            decompose(st, rank, format=fmt, iters=ITERS, seed=0, trace=str(path), **kw)
            launches = kernel.launches
            check(launches == st.nmodes * ITERS, f"traced {fmt}: {launches} launches")
            recs = obs_trace.load_jsonl(path)
            counts = {name: sum(r["ph"] == "X" and r["name"] == name for r in recs)
                      for name in ("decompose", "drive", "sweep", "plan_build")}
            check(counts == {"decompose": 1, "drive": 1, "sweep": ITERS, "plan_build": st.nmodes},
                  f"traced {fmt}: span counts {counts}")
            by_id = {r["id"]: r for r in recs}
            for r in recs:
                if r["name"] == "sweep":
                    drive = by_id[r["parent"]]
                    check(drive["name"] == "drive" and by_id[drive["parent"]]["name"] == "decompose",
                          f"traced {fmt}: a sweep span is not under drive under decompose")
            sweep_ms = [r["dur"] / 1e3 for r in recs if r["name"] == "sweep"]
            steady_ms = statistics.median(sweep_ms[1:])
            gap = steady_ms / main_sweep_ms[fmt] - 1.0
            check(abs(gap) <= TRACE_SWEEP_TOL,
                  f"traced {fmt}: steady sweep span {steady_ms} ms vs {main_sweep_ms[fmt]} ms")
            rows = join_trace(path)
            check(len(rows) == 1 and rows[0]["label"] == label and rows[0]["achieved_pct"] is not None,
                  f"traced {fmt}: join_trace rows {rows}")

            ws = build_ws(st, rank, device="cuda")
            turns = {"on": [], "off": []}
            for turn in TRACE_TURNS:
                metrics.reset()
                decompose(st, rank, format=fmt, iters=ITERS, seed=0, planned=ws, device=ws.device,
                          trace=turn == "on", **kw)
                turns[turn] += [x * 1e3 for x in metrics.histogram("drive.iter_seconds", label=label).sample[1:]]
            on_ms, off_ms = statistics.median(turns["on"]), statistics.median(turns["off"])
            check(on_ms / off_ms <= TRACE_OVERHEAD,
                  f"{fmt}: traced sweep {on_ms} ms against {off_ms} ms untraced")
            out.append({"format": fmt, "launches": launches, "span_counts": counts,
                        "sweep_span_ms": sweep_ms, "steady_sweep_span_ms": steady_ms,
                        "main_sweep_ms": main_sweep_ms[fmt], "steady_vs_main": gap,
                        "join_trace": rows[0], "turns": list(TRACE_TURNS),
                        "traced_sweep_ms": on_ms, "untraced_sweep_ms": off_ms,
                        "traced_over_untraced": on_ms / off_ms})
            del ws
            torch.cuda.empty_cache()
    return out


def before_wide_turns(st, gen: torch.Generator, libs: dict) -> dict:
    """The three kernels on every mode of the NELL-2-size tensor, in turns
    with their sources before the wide paths (`libs`): now, before, now,
    before, ...; the least of each, and the slowdown held to
    BEFORE_WIDE_SLOWDOWN."""
    out = {k: [] for k in BEFORE_WIDE}

    def turns(kind: str, m: int, call) -> None:
        now, before = [], []
        for _ in range(BEFORE_WIDE_TURNS):
            now.append(cuda_ms(call, KERNEL_REPS))
            with kernel_library(kind, libs[kind]):
                before.append(cuda_ms(call, KERNEL_REPS))
        slowdown = min(now) / min(before)
        check(slowdown <= BEFORE_WIDE_SLOWDOWN,
              f"{kind} mode {m}: {min(now)} ms against {min(before)} ms before the wide path")
        out[kind].append({"mode": m, "ms": min(now), "before_wide_ms": min(before), "slowdown": slowdown,
                          "before_wide_run_ms": BEFORE_WIDE_RUN_MS[kind][m]})

    ws = make_planned_cp_als(st, RANK, device="cuda")
    for m in range(st.nmodes):
        plan = ws.plan_for(m)
        facs = random_padded(plan, [rank_padded(RANK)] * plan.n_in, gen)
        turns("mttkrp", m, lambda: mttkrp_blocked(plan, facs))
    del ws, plan, facs
    torch.cuda.empty_cache()
    ws = make_planned_tucker(st, CORE_RANKS, device="cuda")
    for m, op in ws.ops.items():
        facs = random_padded(op.plan, [rank_padded(r) for r in op.in_ranks], gen)
        turns("ttmc", m, lambda: ttmc_blocked(op.plan, facs, op.in_ranks))
    del ws, op, facs
    torch.cuda.empty_cache()
    ws = make_planned_tt(st, TT_RANKS, device="cuda")
    for m, op in ws.ops.items():
        mats = random_padded(op.plan, [rank_padded(a * b) for a, b in op.in_rank_pairs], gen)
        turns("ttcore", m, lambda: ttcore_blocked(op.plan, mats, op.in_rank_pairs, op.n_left))
    del ws, op, mats
    torch.cuda.empty_cache()
    return out


def wide_phase(st, gen: torch.Generator, entries: dict, main_sweep_ms: dict, before_libs: dict) -> None:
    """Phase k: fault F3 on the card (the wide paths at 6 and 7 modes),
    tracing on the card, and the kernels against their sources before the
    wide paths.  Adds each kernel's `wide_modes` to its entry of the
    `kernels` line (`entries`, by kernel)."""
    phase_t0 = time.perf_counter()
    wide = [wide_mode_kernels(n_in, gen) for n_in in WIDE_MODE_TENSORS]
    for kind, entry in entries.items():
        entry["wide_modes"] = [{
            "n_in": w["n_in"], "shape": w["shape"], "nnz": w["nnz"],
            "max_rel_err": max(x["max_rel_err"] for x in w[kind]["modes"]),
            "mode_ms": [x["ms"] for x in w[kind]["modes"]],
            "bound_ms": [x["bound_ms"] for x in w[kind]["modes"]],
        } for w in wide]
    traced = traced_runs(st, main_sweep_ms)
    before = before_wide_turns(st, gen, before_libs)
    emit({"phase": "k", "nvidia_smi": nvidia_smi(), "phase_s": time.perf_counter() - phase_t0,
          "wide_modes": wide, "traced": traced,
          "nell2_main_ms": {k: e["mode_ms"] for k, e in entries.items()},
          "before_wide": {k: str(src.relative_to(ROOT)) for k, src in BEFORE_WIDE.items()},
          "before_wide_turns": before, "tol_full": TOL_FULL, "trace_sweep_tol": TRACE_SWEEP_TOL,
          "trace_overhead_max": TRACE_OVERHEAD, "before_wide_slowdown_max": BEFORE_WIDE_SLOWDOWN})


_KILLED = """
import sys
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.api import decompose
from repro_torch.core.coo import SparseTensor
from repro_torch.testing import faults
from repro_torch.{module} import {make}
st = SparseTensor(np.load({idx!r}), np.load({val!r}), {shape!r})
ws = {make}(st, {rank!r}, device="cuda")
faults.kill_at(ws, at_iter={at}, exit_code={code})
decompose(st, {rank!r}, format={fmt!r}, iters={iters}, seed=0, planned=ws, checkpoint_path={ckpt!r},
          **{kw!r})
"""
_BUILDER_MODULE = {"cp": "kernels.ops", "tucker": "tucker.hooi", "tt": "tt.als"}


def steady_ms(label: str) -> list[float]:
    """The drive's steady sweeps (all but the first), ms, from its
    `drive.iter_seconds` series since the last metrics reset."""
    return [x * 1e3 for x in metrics.histogram("drive.iter_seconds", label=label).sample[1:]]


def sync_loop_ms(st, ws) -> list[float]:
    """The drive's loop without the drive: ITERS sweeps from decompose's
    initial factors (seed 0), each followed by the fit's transfer to the
    host, which every drive pays; the steady iterations' ms by the host
    clock, as `drive.iter_seconds` times them."""
    idx, val = to_device(st, ws.device)
    norm_x_sq = torch.tensor(float((st.values.astype("float64") ** 2).sum()), device=ws.device)
    facs = ws.pad_factors(_initial_factors(st, RANK, None, 0, ws.device))
    out = []
    for it in range(ITERS):
        t0 = time.perf_counter()
        facs, _, fit = ws.sweep(facs, idx, val, norm_x_sq, first=it == 0)
        float(fit)
        out.append((time.perf_counter() - t0) * 1e3)
    return out[1:]


def guard_turns(st, ws, main_sweep_ms: float) -> dict:
    """CP decompose on one workspace under each of GUARD_SETTINGS, and the
    bare sweep-and-sync loop (`sync_loop_ms`), in turns (GUARD_TURNS); the
    median steady sweep of each.  The unguarded drive is held to the bare
    loop, and to phase d's back-to-back sweeps, which pay no sync."""
    sweeps = {k: [] for k in (*GUARD_SETTINGS, "sync")}
    for turn in GUARD_TURNS:
        if turn == "sync":
            sweeps[turn] += sync_loop_ms(st, ws)
            continue
        metrics.reset()
        decompose(st, RANK, iters=ITERS, seed=0, planned=ws, guards=GUARD_SETTINGS[turn])
        sweeps[turn] += steady_ms("cp_als")
    ms = {k: statistics.median(v) for k, v in sweeps.items()}
    over_sync = ms["off"] / ms["sync"] - 1.0
    gap = ms["off"] / main_sweep_ms - 1.0
    check(abs(over_sync) <= UNGUARDED_SWEEP_TOL and abs(gap) <= DRIVE_SYNC_TOL,
          f"unguarded drive sweep {ms['off']} ms against the bare loop's {ms['sync']} ms and "
          f"phase d's {main_sweep_ms} ms")
    return {"turns": list(GUARD_TURNS), "sweep_ms": ms, "phase_d_sweep_ms": main_sweep_ms,
            "unguarded_vs_bare_loop": over_sync, "unguarded_vs_phase_d": gap,
            "over_unguarded": {k: v / ms["off"] for k, v in ms.items()}}


def recovery(st, fmt: str, ws, clean_fit: float) -> list[dict]:
    """A NaN injected after iteration 1 into `ws` under "restart" and
    "fallback": the guard's events, the kernel's launches (none after a
    fallback), the fallback sweeps' ms, the final fit against the clean
    run's."""
    rank, kw, label, kernel, _ = TRACED[fmt]
    out = []
    for policy in ("restart", "fallback"):
        faults.inject_nan_factor(ws, at_iter=1)
        metrics.reset()
        reset_launches()
        with obs_trace.tracing(True) as tr:
            state = decompose(st, rank, format=fmt, iters=ITERS, seed=0, planned=ws,
                              guards=GuardConfig(policy), **kw)
        del ws._sweep_call  # the injector's wrapper
        events = [e["name"] for e in tr.events() if e["name"].startswith(("guard_", "nonfinite"))]
        before_switch = 3 * st.nmodes  # iterations 0-2: the guard fires on iteration 2's fit
        after = kernel.launches - before_switch
        gap = abs(state.fit_history[-1] - clean_fit)
        check(len(state.fit_history) == ITERS and gap <= TOL_RECOVERED,
              f"{fmt} {policy}: fits {state.fit_history}, clean final fit {clean_fit}")
        check(events == [f"guard_{policy}"], f"{fmt} {policy}: events {events}")
        check(after == (ITERS * st.nmodes if policy == "restart" else 0),
              f"{fmt} {policy}: {after} kernel launches after the guard fired")
        sweeps = [x * 1e3 for x in metrics.histogram("drive.iter_seconds", label=label).sample]
        out.append({"format": fmt, "policy": policy, "events": events,
                    "launches_after_switch": after, "fits": state.fit_history,
                    "final_fit_gap": gap, "sweep_ms": sweeps,
                    **({"fallback_sweep_ms": statistics.median(sweeps[3:])}
                       if policy == "fallback" else {})})
        del state
    return out


def killed_and_resumed(st, main_fits: dict, clean_fits: dict) -> list[dict]:
    """CP and TT at NELL-2 size in subprocesses (at once), killed before
    iteration KILL_AT with checkpoints every iteration; then resumed here:
    the restored padded factors and fits against the saved ones, bit for
    bit, the later fits against phases d and h, and the ms per
    checkpoint_save."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        idx, val = Path(tmp) / "indices.npy", Path(tmp) / "values.npy"
        np.save(idx, st.indices)
        np.save(val, st.values)
        procs = {}
        for fmt in ("cp", "tt"):
            rank, kw, _, _, build_ws = TRACED[fmt]
            code = _KILLED.format(src=str(ROOT / "src"), module=_BUILDER_MODULE[fmt],
                                  make=build_ws.__name__, idx=str(idx), val=str(val),
                                  shape=tuple(st.shape), rank=rank, at=KILL_AT, code=KILL_CODE,
                                  fmt=fmt, iters=ITERS, ckpt=str(Path(tmp) / fmt), kw=kw)
            procs[fmt] = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
        for fmt, proc in procs.items():
            log, _ = proc.communicate(timeout=300)
            check(proc.returncode == KILL_CODE,
                  f"killed {fmt}: exit {proc.returncode}, expected {KILL_CODE}:\n{log[-3000:]}")
        for fmt in ("cp", "tt"):
            rank, kw, label, _, build_ws = TRACED[fmt]
            ckpt = str(Path(tmp) / fmt)
            step, saved = CheckpointManager(ckpt).restore(device="cuda")
            check(step == KILL_AT - 1, f"killed {fmt}: latest checkpoint step {step}")
            ws = build_ws(st, rank, device="cuda")
            seen = {}
            inner = ws._sweep_call

            def first_input(facs, *args, it):
                seen.setdefault("facs", tuple(f.clone() for f in facs))
                return inner(facs, *args, it=it)

            ws._sweep_call = first_input
            with obs_trace.tracing(True) as tr:
                state = decompose(st, rank, format=fmt, iters=ITERS, seed=0, planned=ws,
                                  checkpoint_path=ckpt, **kw)
            same = all(torch.equal(a, b) for a, b in zip(seen["facs"], saved["facs"]))
            fits = state.fit_history
            check(same and fits[:KILL_AT] == saved["fits"].tolist() and len(fits) == ITERS,
                  f"resumed {fmt}: restored factors equal {same}, fits {fits} against saved "
                  f"{saved['fits'].tolist()}")
            check(len(tr.events("checkpoint_resume")) == 1, f"resumed {fmt}: no checkpoint_resume")
            later = max(abs(a - b) for a, b in zip(fits[KILL_AT:], main_fits[fmt][KILL_AT:]))
            check(later <= TOL_RECOVERED, f"resumed {fmt}: fits {fits} against {main_fits[fmt]}")
            out.append({"format": fmt, "exit_code": KILL_CODE, "resumed_from_step": step,
                        "restored_factors_equal": same, "saved_fits": saved["fits"].tolist(),
                        "fits": fits, "later_fit_gap": later,
                        "clean_run_to_run_gap": max(abs(a - b) for a, b in
                                                    zip(clean_fits[fmt], main_fits[fmt])),
                        "checkpoint_save_ms": [r["dur"] / 1e3 for r in tr.spans("checkpoint_save")]})
            del ws, state, saved, seen
            torch.cuda.empty_cache()
    return out


def admission_cases(st, cp_total: int, main_cp_fits: list[float], gen: torch.Generator) -> dict:
    """At NELL-2 size, a budget one byte under the CP default's footprint
    (admitted at blk 128); on LADDER_PRESET, a budget under every rung down
    to FLOOR_BLK but over the reference footprint (approach 1, no launch)
    and an impossible one (AdmissionError with every rung); each kernel at
    LADDER_BLKS on the presets against float64."""
    reset_launches()
    with obs_trace.tracing(True) as tr:
        state = decompose(st, RANK, iters=ITERS, seed=0, hbm_budget=cp_total - 1)
    rungs = [(e["args"]["outcome"], e["args"].get("blk")) for e in tr.events("admission_rung")]
    gap = max(abs(a - b) for a, b in zip(state.fit_history, main_cp_fits))
    check(rungs == [("over_budget", 256), ("pallas", 128)]
          and mttkrp_blocked.launches == st.nmodes * ITERS and gap <= TOL_TUNED_FIT,
          f"budget under the CP default: rungs {rungs}, {mttkrp_blocked.launches} launches, "
          f"fits {state.fit_history} against phase d's {main_cp_fits}")
    nell2 = {"budget_bytes": cp_total - 1, "rungs": rungs, "fits": state.fit_history,
             "max_fit_gap_phase_d": gap, "launches": mttkrp_blocked.launches}
    del state
    torch.cuda.empty_cache()

    pst = frostt_like(LADDER_PRESET)
    ref = reference_footprint_bytes(pst, _lane_ranks("cp", RANK, pst.nmodes))
    reset_launches()
    with obs_trace.tracing(True) as tr:
        state = decompose(pst, RANK, iters=3, seed=0, hbm_budget=ref + 1)
    rungs = [(e["args"]["outcome"], e["args"].get("blk")) for e in tr.events("admission_rung")]
    want = decompose(pst, RANK, iters=3, seed=0, method="approach1").fit_history
    top = MemoryControllerConfig().dma.blk
    ladder = [top >> k for k in range(top.bit_length()) if top >> k >= FLOOR_BLK]
    check(rungs == [("over_budget", b) for b in ladder] + [("reference", None)]
          and mttkrp_blocked.launches == 0
          and max(abs(a - b) for a, b in zip(state.fit_history, want)) <= TOL_FIT,
          f"{LADDER_PRESET} under every rung: rungs {rungs}, {mttkrp_blocked.launches} launches, "
          f"fits {state.fit_history} against approach 1's {want}")
    try:
        decompose(pst, RANK, iters=3, seed=0, hbm_budget=ref - 1)
        raise RuntimeError("chip_smoke check failed: an impossible budget was admitted")
    except AdmissionError as err:
        impossible = {"budget_bytes": ref - 1, "ladder_blks": [a["blk"] for a in err.ladder],
                      "reference_bytes": err.reference_bytes}
    check(impossible["ladder_blks"] == ladder, f"impossible budget: ladder {impossible}")

    blocks = []
    for preset in ("tiny", LADDER_PRESET):
        pst = frostt_like(preset)
        for blk in LADDER_BLKS:
            cfg = MemoryControllerConfig(dma=DMAEngineConfig(blk=blk))
            worst = {}
            ws = make_planned_cp_als(pst, RANK, cfg=cfg, device="cuda")
            worst["mttkrp"] = max(check_kernel(
                mttkrp_blocked, mttkrp_blocked_plain, ws.plan_for(m),
                random_padded(ws.plan_for(m), [rank_padded(RANK)] * (pst.nmodes - 1), gen),
                tol=TOL_PRESET, what=f"{preset} blk {blk} MTTKRP mode {m}")["max_rel_err"]
                for m in range(pst.nmodes))
            ws = make_planned_tucker(pst, PRESET_CORE_RANKS[preset], cfg=cfg, device="cuda")
            worst["ttmc"] = max(check_kernel(
                ttmc_blocked, ttmc_blocked_plain, op.plan,
                random_padded(op.plan, [rank_padded(r) for r in op.in_ranks], gen), op.in_ranks,
                tol=TOL_PRESET, what=f"{preset} blk {blk} TTMc mode {m}")["max_rel_err"]
                for m, op in ws.ops.items())
            ws = make_planned_tt(pst, PRESET_TT_RANKS[preset], cfg=cfg, device="cuda")
            worst["ttcore"] = max(check_kernel(
                ttcore_blocked, ttcore_blocked_plain, op.plan,
                random_padded(op.plan, [rank_padded(a * b) for a, b in op.in_rank_pairs], gen),
                op.in_rank_pairs, op.n_left,
                tol=TOL_PRESET, what=f"{preset} blk {blk} TT-core mode {m}")["max_rel_err"]
                for m, op in ws.ops.items())
            blocks.append({"preset": preset, "blk": blk, "max_rel_err": worst})
            del ws
    return {"nell2_one_byte_under": nell2,
            "preset_under_every_rung": {"preset": LADDER_PRESET, "budget_bytes": ref + 1,
                                        "reference_bytes": ref, "rungs": rungs,
                                        "fits": state.fit_history, "approach1_fits": want},
            "preset_impossible": impossible, "ladder_blocks": blocks, "tol_preset": TOL_PRESET}


def resilience_phase(st, main_fits: dict, main_sweep_ms: float, gen: torch.Generator) -> None:
    """Phase l: the resilience layer at NELL-2 size (see the module
    docstring), with `main_fits` the fits of phases d, f and h and
    `main_sweep_ms` phase d's CP sweep."""
    phase_t0 = time.perf_counter()
    clean, peaks, footprint, workspaces = {}, {}, [], {}
    for fmt, (rank, kw, _, _, _) in TRACED.items():  # nothing else alive on the card
        torch.cuda.reset_peak_memory_stats()
        state = decompose(st, rank, format=fmt, iters=ITERS, seed=0, **kw)
        peaks[fmt] = torch.cuda.max_memory_allocated()
        clean[fmt] = state.fit_history
        del state
        torch.cuda.empty_cache()
    for fmt, (rank, _, _, _, build_ws) in TRACED.items():
        workspaces[fmt] = build_ws(st, rank, device="cuda")
        report = admission_bytes(workspaces[fmt])
        footprint.append({"format": fmt, **report, "peak_device_bytes": peaks[fmt],
                          "peak_over_admission": peaks[fmt] / report["total_bytes"],
                          "fits": clean[fmt], "main_fits": main_fits[fmt],
                          "run_to_run_gap": max(abs(a - b) for a, b in zip(clean[fmt], main_fits[fmt]))})
    guards = guard_turns(st, workspaces["cp"], main_sweep_ms)
    recovered = [r for fmt, ws in workspaces.items() for r in recovery(st, fmt, ws, clean[fmt][-1])]
    cp_total = footprint[0]["total_bytes"]
    del workspaces
    torch.cuda.empty_cache()
    resumed = killed_and_resumed(st, main_fits, clean)
    admission = admission_cases(st, cp_total, main_fits["cp"], gen)
    emit({"phase": "l", "nvidia_smi": nvidia_smi(), "phase_s": time.perf_counter() - phase_t0,
          "footprint": footprint, "guards": guards, "recovery": recovered, "resumed": resumed,
          "admission": admission, "tol_recovered": TOL_RECOVERED,
          "unguarded_sweep_tol": UNGUARDED_SWEEP_TOL, "drive_sync_tol": DRIVE_SYNC_TOL})


if __name__ == "__main__":
    sys.exit(main())
