"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, runs CP-ALS, Tucker HOOI and
TT-ALS at NELL-2's published size (12,092 x 9,184 x 28,818, 76,879,419 non-zeros,
synthetic stand-in with seed 0 and zipf skew 1.1) through
`repro_torch.api.decompose`, and measures the kernels; then serves the LM
stack's models at full width (phase n) and trains them (phase o).  Phases, each
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
              (span counts and nesting, join_trace's achieved_pct) and the
              drive with tracing on against off, in turns (the steady sweep
              spans and the traced sweeps against the untraced sweeps;
              phases d, f and h's printed beside them); the three kernels at
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
  m  dist.    the sharded planned path on the same tensor, D = 2 and 4
              shards on the one card (shard_plan(["cuda:0"] * D)): per
              format and D, the partition (tile bounds, shard nnz, the
              makespan report) and the plan build; each mode's sharded
              kernel output (one launch per shard, then the reduction)
              against float64 (MTTKRP within 1e-5 of a column's max, TTMc
              and TT-core within 1e-4) and against the single-device
              output; ms per shard and per mode, and the reduction's ms;
              the sharded sweep in turns with the single-device one;
              decompose(..., method="pallas_sharded", iters=3) with the
              launch counters reset just before and read just after (D x
              modes x iterations launches), its peak device memory and its
              fits against phases d, f and h within 1e-5;
              mttkrp_sharded(method="approach1") on mode 0 against float64;
              search_sharded for D = 4 (its pick, host seconds); the plan
              cache cleared at the end
  n  serving  the LM stack's serving path, which reaches none of the
              kernels above (their counters stay 0): qwen3-0.6b as
              configured (28 layers, d 1,024, vocabulary 151,936, float32
              weights, bfloat16 compute) through launch.serve.serve, batch
              8, prompt 512, 64 new tokens, seed 0, after a warm-up run
              (prefill and decode ms and tok/s, peak device memory, the
              first continuation ids; prefills and decode steps profiled:
              kernels per call, device ms, the device's idle share, the top
              kernels); its float32 re-run, decode after prefill within 1e-3
              of the largest |logit| of a prefill over the longer prompt;
              every other family at full width, cut in depth (phi3.5-moe 1
              layer, in both dispatch modes with the same drops, jamba 8,
              llama-3.2-vision 5, grok-1 1; mamba2-370m and whisper-large-v3
              whole): a prefill of 4 x 256 and 16 decode steps after a
              warm-up, finite float32 logits, ms, peak memory, the decode
              step profiled
  o  training the LM stack's training path (no decomposition kernel; the
              counters stay 0): qwen3-0.6b as configured (28 layers, d 1,024,
              vocabulary 151,936, float32 masters, bfloat16 compute, remat)
              through launch.train.train_once, batch 8 x seq 512, 2
              microbatches, AdamW with warmup 2, 12 steps, seed 0 (ms a step
              as the median of steps 3-12, tokens/s, peak device memory, the
              loss at every step: finite, the last below the first), then 2
              steps profiled (kernels a step, device ms, idle share); the
              reduced config in float32, 3 steps on the card and on the CPU
              from one state (losses within 1e-5, parameters within 1e-4);
              at full width in float32, remat on against off (losses within
              1e-5, both peaks), 2 microbatches against 1 (one step: the
              accumulated gradient within 1e-5 of each leaf's largest
              value; the parameters' gap reported) and int8 error feedback for 5 steps
              (finite, falling); phi3.5-moe (1 layer, both dispatch modes,
              the same drops), llama-3.2-vision (5), mamba2-370m and
              whisper-large-v3 (whole) at full width, 4 x 256 for 4 steps
              at lr 1e-4 (finite); the same four at the same depth in
              float32, one loss and its gradients on 1 x 64 tokens on the
              card against the CPU from one state (the losses within 1e-5
              relative, each leaf's gradient within its bound);
              why jamba and grok-1 are not trained on one card
  p  mesh     the LM stack on a `DeviceMesh` (no decomposition kernel; the
              counters stay 0): a one-rank NCCL process group begun in
              this process (tcp://localhost, a free port) and a 1 x 1
              ("data", "model") mesh from launch.mesh.make_host_mesh;
              qwen3-0.6b at full width and depth through launch.train.main
              on the mesh (8 x 512 in 2 microbatches, remat, 6 steps: ms a
              step, peak device memory, the losses finite and falling),
              every parameter and every gradient AdamW receives a DTensor
              on the mesh; 2 steps from seed 0 on the mesh and off it
              (losses within 1e-5 relative, parameters within 1e-5 of each
              leaf's largest |value|); a mesh step and a plain step in
              turns (host ms), then a mesh step profiled (device ms, idle
              share; the plain step's are phase o's); launch.serve.main on
              the mesh (8 x 512 prompts, 16
              new tokens) and the plain `serve` in turns, tokens equal;
              beside phase o's and phase n's numbers of this run
  q  dry run  repro_torch.launch.dryrun (no decomposition kernel; the
              counters stay 0), in a subprocess of its own with
              PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True, after phase
              p's NCCL group is gone: phase o's cell (launch.train's step
              for TRAIN_MAIN_ARGS) on a one-rank fake process group and mesh,
              its peak within 5% of phase p's mesh peak (the gap to phase
              o's reported), its arguments' bytes, each rounded to the
              allocator's 512 bytes, equal to what the same state and batch
              take on the card; phase n's prefill (8 x 512, cache 576) and
              decode (8 sequences, cache 576) with bfloat16 parameters,
              each dry-run peak within 10% of that step's peak on the card;
              no device memory allocated by any dry run, no process group
              left; `python -m repro_torch.launch.dryrun --arch qwen3-0.6b
              --shape decode_32k` as a subprocess (exit 0, its record ok,
              peak per device beside the card's memory)
  r  entries  the port's entry points, each once through its main(argv)
              on the card (exit code, seconds, kernel launches; every exit
              code 0): scripts/torch_calibrate.py at --preset tiny --rank 8
              --reps 2 into a temporary autotune cache, then --check-hit on
              it (a hit and no miss); examples/quickstart_torch.py --fast
              for CP, Tucker and TT with --devices 1 and --devices 2 (2
              shards in turn on the card: the sharded fits within 1e-5 of
              one device's), --fast --auto-tune cached twice (the second
              evaluates no configuration) and traced;
              scripts/torch_trace_report.py on that trace with --pms; the
              examples train_lm_torch (20 steps), serve_batch_torch,
              fault_tolerance_demo_torch (the injected failure at step 13,
              the restore from step 8, exit 0) and moe_dispatch_demo_torch
              (the two dispatch modes within 1e-5)

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
from unittest import mock

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
from repro_torch.core.mttkrp import hadamard_rows, mttkrp, mttkrp_sharded  # noqa: E402
from repro_torch.dist import Replicas, reduce_partials  # noqa: E402
from repro_torch.dist.planned import (  # noqa: E402
    make_sharded_planned_cp_als,
    make_sharded_planned_tt,
    make_sharded_planned_tucker,
    shard_makespan_report,
    shard_plan,
)
from repro_torch.core.remap import radix_digits, remap_radix, remap_stable  # noqa: E402
from repro_torch.core.memctrl import (  # noqa: E402
    CacheEngineConfig,
    DMAEngineConfig,
    GPUSpec,
    MemoryControllerConfig,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.serve import main as launch_serve_main, serve  # noqa: E402
from repro_torch.serve.engine import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train import train_step as train_step_mod  # noqa: E402
from repro_torch.train.stacks import members  # noqa: E402
from repro_torch.train.train_step import init_train_state, make_train_step  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.models.layers import norm_apply  # noqa: E402
from repro_torch.kernels.mttkrp import mttkrp_blocked, mttkrp_blocked_plain, rank_padded  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    _stack_call,
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
# Tracing: the traced drives' steady sweep spans against the untraced
# drives' steady sweeps, and the traced sweep against the untraced one, at
# most; both sides timed in the same turns on one workspace.  The Tucker
# sweep's level shifts by up to 5% within a run on an H100, traced or not,
# back to back or driven (scripts/torch_trace_probe.py), so each side pools
# the steady sweeps of several drives.
TRACE_SWEEP_TOL = 0.05
TRACE_OVERHEAD = 1.03
TRACE_TURNS = ("on", "off", "off", "on") * 3
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
# Phase m: the sharded planned path, D shards on the one card; its runs'
# iterations (fits held to the first SHARD_ITERS of phases d, f and h within
# TOL_FIT); the sharded and single-device sweeps in turns; the shard count
# the sharded PMS search runs at.
SHARD_COUNTS = (2, 4)
SHARD_ITERS = 3
SHARD_TURNS = ("single", "sharded", "sharded", "single")
SHARD_SEARCH_D = 4
# Phase n: the LM stack's serving path.  The main path: qwen3-0.6b as
# configured (28 layers, d 1,024, vocabulary 151,936, float32 weights,
# bfloat16 compute), batch 8, prompt 512, 64 new tokens, seed 0, after one
# warm-up run of SERVE_WARMUP_TOKENS.  Its float32 re-run holds decode after
# prefill to a prefill over the longer prompt within TOL_DECODE of the
# largest |logit|.  Every other family at full width, its depth cut to the
# layers named (None: whole), a prefill of FAMILY_BATCH x FAMILY_PROMPT and
# FAMILY_DECODE_STEPS decode steps.
SERVE_ARCH = "qwen3-0.6b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_SEED = 8, 512, 64, 0
SERVE_WARMUP_TOKENS = 4
TOL_DECODE = 1e-3
FAMILY_LAYERS = {"phi3.5-moe-42b-a6.6b": 1, "jamba-v0.1-52b": 8, "llama-3.2-vision-11b": 5,
                 "grok-1-314b": 1, "mamba2-370m": None, "whisper-large-v3": None}
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_DECODE_STEPS = 4, 256, 16
BOTH_DISPATCH = "phi3.5-moe-42b-a6.6b"  # served once per MoE dispatch mode
# Prefills and decode steps timed, then as many profiled (torch.profiler):
# kernels per call, device ms, the device's idle share of the unprofiled
# host time, the top kernels by device time.
PROFILE_REPS = 3
PROFILE_TOP = 8
# Phase o: the LM stack's training path.  The main path: qwen3-0.6b as
# configured through launch.train (TRAIN_MAIN_ARGS); ms a step is the
# median of steps 3-12 (host clock; the loss's transfer syncs), then
# TRAIN_PROFILE_STEPS steps timed and as many profiled.  Held to the CPU:
# the reduced config in float32, TRAIN_CPU_STEPS steps on both from one
# state; held to itself at full width in float32: remat on against off
# (TRAIN_SELF_STEPS steps), 2 microbatches against 1 (one step from each of
# TRAIN_MB_SEEDS), int8 error feedback (TRAIN_COMPRESS_STEPS steps).
# Losses within TOL_TRAIN_LOSS relative, parameters within TOL_TRAIN_PARAM
# of each leaf's largest |value|.  2 microbatches against 1: the gradient
# AdamW receives within TOL_TRAIN_GRAD of each leaf's largest |gradient|;
# the parameters after that step held to what Adam's first step,
# lr s g / (s |g| + 1e-8) with s the clip scale, allows: every element
# within 2 lr (plus 2^-21 of the leaf's largest |value| for the rounding of
# the subtraction), since that step moves an element by less than lr either
# way whatever its gradient; and the elements whose |gradient| is at least
# TRAIN_MB_SHARP times the leaf's gradient gap (their update cannot turn on
# that gap) within TOL_TRAIN_PARAM.  The other families at full width,
# depth cut to what one card holds, TRAIN_FAMILY_BATCH x TRAIN_FAMILY_SEQ
# for TRAIN_FAMILY_STEPS steps at TRAIN_FAMILY_LR (at qwen3's 1e-3 the
# d 4,096 models' losses jump).
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_LR, TRAIN_SEED = 1e-3, 0
TRAIN_MAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", "12", "--batch", "8", "--seq", "512", "--microbatches", "2",
                   "--warmup", "2", "--lr", str(TRAIN_LR), "--seed", str(TRAIN_SEED), "--log-every", "4"]
TRAIN_MEDIAN_FROM = 2  # steps 3-12 (0-based 2-11)
TRAIN_PROFILE_STEPS = 2
TRAIN_CPU_STEPS, TRAIN_SELF_STEPS, TRAIN_COMPRESS_STEPS = 3, 2, 5
# TOL_TRAIN_GRAD: measured 5.7e-6 to 7.1e-6 over TRAIN_MB_SEEDS on an H100
# (a norm scale's or an attention weight's sums over the 4,096 tokens in
# two halves against one).
TOL_TRAIN_LOSS, TOL_TRAIN_PARAM, TOL_TRAIN_GRAD = 1e-5, 1e-4, 2e-5
TRAIN_MB_SEEDS, TRAIN_MB_SHARP = (0, 1, 2), 1e3
TRAIN_FAMILIES = {"phi3.5-moe-42b-a6.6b": 1, "llama-3.2-vision-11b": 5, "mamba2-370m": None,
                  "whisper-large-v3": None}
TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_STEPS, TRAIN_FAMILY_LR = 4, 256, 4, 1e-4
# The families of TRAIN_FAMILIES at the same depth, in float32 (remat off,
# for the CPU's time), held card against CPU: one loss and its gradients on
# FAMILY_GRAD_BATCH x FAMILY_GRAD_SEQ tokens from one state drawn on the
# card (its parameters copied to the CPU: a round trip through numpy,
# convert.train_state_to_numpy and params_from_numpy, took 10.6 and 12.3 s
# of the 56.7 s check for phi3.5-moe and llama in one run, past its 45 s
# budget; measured on one H100); the losses within TOL_TRAIN_LOSS
# relative, each leaf's gradient within TOL_FAMILY_GRAD of its largest
# |gradient| on the CPU, or the bound FAMILY_GRAD_NAMED gives the (arch,
# leaf kind: the name without its layer).
# The bounds, each at 2.6 times or more its reading (measured on one H100,
# "NVIDIA H100 80GB HBM3, 700.00 W"): every leaf kind of phi3.5-moe within
# 2.80e-6 (attn.wv), llama-3.2-vision 4.84e-6 (norm2.scale), whisper (8
# layers) 7.75e-6 (attn.wk); mamba2-370m's 48 layers of the SSD scan, whose
# float32 sums and exponentials round in other orders on the two devices,
# 2.29e-5 (mamba.conv_w), and its decay's leaves 5.14e-5 (mamba.A_log) and
# 4.01e-5 (mamba.dt_bias); the losses within 8.6e-8.
FAMILY_GRAD_BATCH, FAMILY_GRAD_SEQ = 1, 64
TOL_FAMILY_GRAD = 2e-5
FAMILY_GRAD_NAMED = {("mamba2-370m", kind): 7e-5 for kind in (
    "embed", "norm1.scale", "mamba.in_proj", "mamba.conv_w", "mamba.conv_b", "mamba.D", "mamba.out_proj",
    "mamba.out_norm.scale", "norm_f.scale")}
FAMILY_GRAD_NAMED.update({("mamba2-370m", "mamba.A_log"): 2e-4, ("mamba2-370m", "mamba.dt_bias"): 1.5e-4})
# whisper's encoder and decoder cut to 8 layers of 32 here: whole, its
# 1,500-frame encoder took 33.9 s on the 8-thread CPU of an H100 machine
# and the check 155 s.
FAMILY_GRAD_LAYERS = {"whisper-large-v3": 8}
# Not trained on one card: one period / layer (with the embeddings) at 14 B
# a parameter (fsdp archs: float32 master, bfloat16 m, v, cast, gradient).
TRAIN_NOT_ON_ONE_CARD = {"jamba-v0.1-52b": 8, "grok-1-314b": 1}
CARD_BYTES = 80e9
# Phase p: the LM stack on a one-rank mesh.  launch.train.main with
# MESH_TRAIN_ARGS (phase o's main path on a 1 x 1 mesh, 6 steps; ms a step
# the median from step 3), MESH_HELD_STEPS steps on and off the mesh from
# one seed held within TOL_MESH (losses relative, parameters of each leaf's
# largest |value|), MESH_TURNS steps of each in turns; launch.serve.main
# with MESH_SERVE_ARGS and the plain `serve` in turns, tokens equal.
MESH_TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", "6", "--batch", "8", "--seq", "512", "--microbatches", "2",
                   "--warmup", "2", "--lr", str(TRAIN_LR), "--seed", str(TRAIN_SEED), "--log-every", "2",
                   "--mesh-data", "1", "--mesh-model", "1"]
MESH_MEDIAN_FROM = 2
MESH_HELD_STEPS, MESH_TURNS, TOL_MESH = 2, 2, 1e-5
MESH_SERVE_NEW = 16
MESH_SERVE_ARGS = ["--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT),
                   "--new-tokens", str(MESH_SERVE_NEW), "--seed", str(SERVE_SEED), "--mesh-data", "1",
                   "--mesh-model", "1"]
# Phase q: the dry run (repro_torch.launch.dryrun), in a subprocess of its
# own under expandable segments (every block split to its 512-byte-rounded
# request, so memory_allocated() gains exactly the rounded sizes).  Phase
# o's cell on a one-rank fake mesh held within TOL_DRY_TRAIN of phase p's
# mesh peak, its arguments equal to the state's rounded bytes on the card;
# phase n's prefill (SERVE_BATCH x SERVE_PROMPT, cache SERVE_PROMPT +
# SERVE_NEW) and decode (SERVE_BATCH sequences against that cache) in
# bfloat16 within TOL_DRY_SERVE of one step on the card; DRY_CELLS through
# `python -m repro_torch.launch.dryrun` as a user runs it, each within
# DRY_CELL_TIMEOUT_S (train_4k, 48 s of phase q on an H100's host, is left
# out: with it the whole script took 1,054 s of its 1,200).
TOL_DRY_TRAIN, TOL_DRY_SERVE = 0.05, 0.10
ALLOC_ROUND = 512
DRY_CELLS = (("qwen3-0.6b", "decode_32k"),)
DRY_CELL_TIMEOUT_S, DRY_PHASE_TIMEOUT_S = 120, 300
DRY_ALLOC_CONF = "expandable_segments:True"
# Phase r: the port's entry points, each once through its main(argv) on the
# card, every exit code 0.  The calibration CLI into a temporary autotune
# cache, then --check-hit on it (a hit, no miss: nothing calibrated again
# by the resolve); quickstart --fast for each format with --devices 1 and 2
# (the sharded fits within TOL_SHARD_FIT of one device's, every iteration);
# quickstart --fast --auto-tune cached twice (the second run evaluates no
# configuration, a cache hit per mode) and traced, and the trace report on
# that trace with --pms; the four examples (train_lm_torch at
# ENTRY_TRAIN_LM_STEPS steps; the MoE demo's dispatch modes within
# TOL_MOE_MODES of each other).  Phase r's budget is 60 s.
CALIBRATE_ARGS = ["--preset", "tiny", "--rank", "8", "--reps", "2"]
TOL_SHARD_FIT = 1e-5
ENTRY_TRAIN_LM_STEPS = 20
TOL_MOE_MODES = 1e-5


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
    torch.cuda.empty_cache()
    dist_phase(st, {"cp": fits, "tucker": tucker_fits, "tt": tt_fits}, gen, entries)
    torch.cuda.empty_cache()
    serve_main_path = serving_phase()
    train_main_path = training_phase()
    mesh_peak = mesh_phase(serve_main_path, train_main_path)
    dryrun_phase(train_main_path["peak_device_bytes"], mesh_peak)
    entry_points_phase()

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
    the span counts and nesting and join_trace's row; then on one workspace
    the drive with tracing on and off in turns (TRACE_TURNS), each drive's
    steady sweeps timed by its `drive.iter_seconds` series and, when traced,
    by its sweep spans.  The steady sweep spans (the first run's and the
    traced turns') are held to the untraced turns' sweeps, and the traced
    sweeps to the untraced ones.  Phases d, f and h's back-to-back sweeps,
    which pay no per-sweep fit transfer and were timed minutes earlier, are
    printed beside them."""
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
            rows = join_trace(path)
            check(len(rows) == 1 and rows[0]["label"] == label and rows[0]["achieved_pct"] is not None,
                  f"traced {fmt}: join_trace rows {rows}")

            ws = build_ws(st, rank, device="cuda")
            turns = {"on": [], "off": []}
            spans = list(sweep_ms[1:])
            for turn in TRACE_TURNS:
                metrics.reset()
                tracer = obs_trace.Tracer() if turn == "on" else None
                decompose(st, rank, format=fmt, iters=ITERS, seed=0, planned=ws, device=ws.device,
                          trace=tracer, **kw)
                turns[turn] += [x * 1e3 for x in metrics.histogram("drive.iter_seconds", label=label).sample[1:]]
                if tracer is not None:
                    spans += [r["dur"] / 1e3 for r in tracer.records if r["name"] == "sweep"][1:]
            on_ms, off_ms = statistics.median(turns["on"]), statistics.median(turns["off"])
            steady_ms = statistics.median(spans)
            gap = steady_ms / off_ms - 1.0
            check(abs(gap) <= TRACE_SWEEP_TOL,
                  f"traced {fmt}: steady sweep span {steady_ms} ms vs {off_ms} ms untraced")
            check(on_ms / off_ms <= TRACE_OVERHEAD,
                  f"{fmt}: traced sweep {on_ms} ms against {off_ms} ms untraced")
            out.append({"format": fmt, "launches": launches, "span_counts": counts,
                        "sweep_span_ms": sweep_ms, "steady_sweep_span_ms": steady_ms,
                        "steady_vs_untraced": gap, "main_sweep_ms": main_sweep_ms[fmt],
                        "steady_vs_main": steady_ms / main_sweep_ms[fmt] - 1.0,
                        "join_trace": rows[0], "turns": list(TRACE_TURNS),
                        "traced_sweep_ms": on_ms, "untraced_sweep_ms": off_ms,
                        "traced_over_untraced": on_ms / off_ms,
                        "traced_samples_ms": turns["on"], "untraced_samples_ms": turns["off"]})
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


def sharded_formats(dev: torch.device, gen: torch.Generator) -> dict:
    """Per format: the rank, the single-device and sharded workspace
    constructors, the format's kernel (entry key, wrapper, plain version and
    the extra arguments it takes at mode m), the bar against float64, the
    decompose keywords, random true factors, and whether the single-device
    sweep takes the stream."""
    pairs = _tt_bond_pairs(TT_RANKS, len(NELL2_SHAPE))

    def others(xs, m):
        return tuple(x for k, x in enumerate(xs) if k != m)

    return {
        "cp": dict(rank=RANK, single=make_planned_cp_als, sharded=make_sharded_planned_cp_als,
                   entry="mttkrp", kernel=mttkrp_blocked, plain=mttkrp_blocked_plain,
                   extra=lambda m: (), tol=TOL_PRESET, kw={}, stream=True,
                   true=lambda st: [torch.randn((s, RANK), generator=gen, device=dev) / math.sqrt(RANK)
                                    for s in st.shape]),
        "tucker": dict(rank=CORE_RANKS, single=make_planned_tucker, sharded=make_sharded_planned_tucker,
                       entry="ttmc", kernel=ttmc_blocked, plain=ttmc_blocked_plain,
                       extra=lambda m: (others(CORE_RANKS, m),), tol=TOL_FULL, kw={}, stream=False,
                       true=lambda st: init_tucker_factors(st.shape, CORE_RANKS, seed=0, device=dev)),
        "tt": dict(rank=TT_RANKS, single=make_planned_tt, sharded=make_sharded_planned_tt,
                   entry="ttcore", kernel=ttcore_blocked, plain=ttcore_blocked_plain,
                   extra=lambda m: (others(pairs, m), m), tol=TOL_FULL, kw={"init": "random"},
                   stream=True,
                   true=lambda st: [core_to_matrix(c) for c in
                                    init_tt_cores(st.shape, TT_RANKS, seed=0, device=dev)]),
    }


def dist_phase(st, main_fits: dict, gen: torch.Generator, entries: dict) -> None:
    """Phase m on the NELL-2-size tensor `st`: the sharded planned path, D
    shards on the one card, for CP, Tucker and TT (see the module
    docstring).  Adds each kernel's sharded launches to its entry of the
    `kernels` line (`entries`, keyed "mttkrp", "ttmc", "ttcore")."""
    phase_t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    plan_cache_clear()
    idx, val = to_device(st, dev)
    norm_x_sq = torch.tensor(float((st.values.astype("float64") ** 2).sum()), device=dev)
    formats = sharded_formats(dev, gen)
    # The single-device workspaces stay alive for the phase (three layouts,
    # about 15.5 GB): their outputs and sweeps are what the shards are
    # held to.  Each kernel's float64 output per mode, on random factors.
    prepared = {}
    for fmt, f in formats.items():
        single, build_s = host_s(lambda: f["single"](st, f["rank"], device=dev))
        true = f["true"](st)
        facs = single.pad_factors(true)
        modes = []
        for m in range(st.nmodes):
            plan = single.plan_for(m)
            in_facs = [facs[im][: plan.in_rows[n]] for n, im in enumerate(plan.in_modes)]
            extra = f["extra"](m)
            exact = f["plain"](dataclasses.replace(plan, vals=plan.vals.double()),
                               [x.double() for x in in_facs], *extra)
            modes.append({"exact": exact, "single": f["kernel"](plan, in_facs, *extra)})
        prepared[fmt] = {"single": single, "build_s": build_s, "true": true, "facs": facs, "modes": modes}
    torch.cuda.synchronize()

    results = []
    for nshards in SHARD_COUNTS:
        dist = shard_plan([dev] * nshards)
        plan_cache_clear()
        for fmt, f in formats.items():
            pre = prepared[fmt]
            # CP builds the layouts; Tucker and TT take them from the plan
            # cache (one layout per tensor, config and shard count).
            ws, build_s = host_s(lambda: f["sharded"](st, f["rank"], dist=dist))
            report = shard_makespan_report(ws)
            reps = Replicas(pre["facs"], dist.devices)
            modes = []
            for m in range(st.nmodes):
                extra = f["extra"](m)
                outs = _stack_call(ws.stacks[m], f["kernel"], reps, *extra)
                got = reduce_partials(outs)
                torch.cuda.synchronize()
                exact, single_out = pre["modes"][m]["exact"], pre["modes"][m]["single"]
                abs_err, rel_err = errors(got, exact)
                check(rel_err <= f["tol"], f"{fmt} {nshards} shards mode {m}: sharded rel err {rel_err}")
                _, gap_single = errors(got, single_out.double())
                stack = ws.stacks[m]
                shard_ms = []
                for plan in stack.plans:
                    facs_d = reps.on(plan.device)
                    in_facs = [facs_d[im][: plan.in_rows[n]] for n, im in enumerate(plan.in_modes)]
                    shard_ms.append(cuda_ms(lambda: f["kernel"](plan, in_facs, *extra), KERNEL_REPS))
                modes.append({"mode": m, "tile_bounds": list(stack.tile_bounds),
                              "shard_nnz": list(stack.shard_nnz),
                              "shard_nblocks": list(stack.shard_nblocks),
                              "max_abs_err": abs_err, "max_rel_err": rel_err,
                              "max_rel_gap_single": gap_single, "shard_ms": shard_ms,
                              "sum_shard_ms": sum(shard_ms),
                              "reduce_ms": cuda_ms(lambda: reduce_partials(outs), KERNEL_REPS)})
                del outs, got
            # The sharded sweep in turns with the single-device one, each
            # from the same factors after one warm sweep.
            single = pre["single"]
            args_single = (idx, val, norm_x_sq) if f["stream"] else (norm_x_sq,)
            runs = {"single": (single, args_single), "sharded": (ws, (norm_x_sq,))}
            facs = {k: w.sweep(w.pad_factors(pre["true"]), *a, first=True)[0]
                    for k, (w, a) in runs.items()}
            turns = {"single": [], "sharded": []}
            for k in SHARD_TURNS:
                w, a = runs[k]
                turns[k].append(cuda_ms(lambda: w.sweep(facs[k], *a), SWEEP_REPS))
            del facs
            # The main path, as a user calls it, on this workspace.
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            state, decompose_s = host_s(lambda: decompose(
                st, f["rank"], format=fmt, method="pallas_sharded", planned=ws, iters=SHARD_ITERS,
                seed=0, **f["kw"]))
            launches = {"mttkrp": mttkrp_blocked.launches, "ttmc": ttmc_blocked.launches,
                        "ttcore": ttcore_blocked.launches}
            peak = torch.cuda.max_memory_allocated()
            want = nshards * st.nmodes * SHARD_ITERS
            check(launches[f["entry"]] == want and sum(launches.values()) == want,
                  f"{fmt} {nshards} shards: launches {launches}, expected {want} of {f['entry']}")
            fits = state.fit_history
            gap = max(abs(a - b) for a, b in zip(fits, main_fits[fmt][:SHARD_ITERS]))
            check(len(fits) == SHARD_ITERS and gap <= TOL_FIT,
                  f"{fmt} {nshards} shards: fits {fits} against {main_fits[fmt][:SHARD_ITERS]}")
            results.append({
                "format": fmt, "nshards": nshards, "devices": [str(d) for d in dist.devices],
                "single_plan_build_s": pre["build_s"], "plan_build_s": build_s,
                "plan_bytes": ws.plan_bytes(), "single_plan_bytes": single.plan_bytes(),
                "makespan_report": {str(k): v for k, v in report["modes"].items()},
                "worst_block_imbalance": report["worst_block_imbalance"], "modes": modes,
                "sweep_ms": min(turns["sharded"]), "single_sweep_ms": min(turns["single"]),
                "sweep_turns_ms": turns, "launches": launches[f["entry"]],
                "decompose_s": decompose_s, "resident_before_bytes": resident,
                "peak_device_bytes": peak, "fits": fits,
                "main_fits": main_fits[fmt][:SHARD_ITERS], "max_fit_gap": gap})
            entries[f["entry"]].setdefault("sharded", []).append({
                "nshards": nshards, "launches": launches[f["entry"]],
                "mode_sum_shard_ms": [x["sum_shard_ms"] for x in modes],
                "mode_reduce_ms": [x["reduce_ms"] for x in modes],
                "max_rel_err": max(x["max_rel_err"] for x in modes)})
            del ws, state, reps
        plan_cache_clear()
        torch.cuda.empty_cache()
    del prepared
    torch.cuda.empty_cache()

    # The compute pattern over the shards: approach 1 on mode 0, the stream
    # sorted by mode 0 and cut into SHARD_SEARCH_D pieces.
    dist = shard_plan([dev] * SHARD_SEARCH_D)
    sidx, sval, _ = remap_stable(idx, val, 0)
    true = formats["cp"]["true"](st)
    fn = mttkrp_sharded(dist, 0, st.shape[0], method="approach1", sorted_by_mode=True)
    got = fn(sidx, sval, true)
    _, pattern_err = errors(got, exact_mttkrp(idx, val, true, 0, st.shape[0]))
    check(pattern_err <= TOL_FULL, f"mttkrp_sharded approach1: rel err {pattern_err}")
    pattern_ms = cuda_ms(lambda: fn(sidx, sval, true), PATTERN_REPS)
    del sidx, sval, got, true, idx, val
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    best = pms.search_sharded(st, 0, RANK, SHARD_SEARCH_D, top_k=PMS_LISTED)
    search_s = time.perf_counter() - t0
    default = pms.predict_sharded(st, 0, RANK, SHARD_SEARCH_D, MemoryControllerConfig(), exact=False)
    plan_cache_clear()
    emit({"phase": "m", "nvidia_smi": nvidia_smi(), "phase_s": time.perf_counter() - phase_t0,
          "iters": SHARD_ITERS, "runs": results,
          "mttkrp_sharded_approach1": {"nshards": SHARD_SEARCH_D, "mode": 0, "ms": pattern_ms,
                                       "max_rel_err": pattern_err},
          "search_sharded": {"nshards": SHARD_SEARCH_D, "mode": 0, "kernel": "mttkrp",
                             "host_s": search_s,
                             "top": [{"cfg": cfg_label(e.cfg), "t_total": e.t_total, "t_sum": e.t_sum,
                                      "critical_shard": e.critical_shard, "imbalance": e.imbalance}
                                     for e in best],
                             "default": {"cfg": cfg_label(default.cfg), "t_total": default.t_total,
                                         "t_sum": default.t_sum}},
          "plan_cache_after": plan_cache_stats()["size"],
          "tol_mttkrp": TOL_PRESET, "tol_ttmc_ttcore": TOL_FULL, "tol_fit": TOL_FIT})


def served(cfg, batch: int, prompt: int, new: int) -> tuple[dict, dict]:
    """`launch.serve.serve` on cuda:0 from seed SERVE_SEED, with its peak
    device memory over what was allocated before; returns (the run, its
    numbers).  Decode is new - 1 greedy steps."""
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run = serve(cfg, batch=batch, prompt_len=prompt, new_tokens=new, seed=SERVE_SEED, device="cuda")
    steps = new - 1
    logits = run["logits"]
    check(tuple(run["tokens"].shape) == (batch, new), f"{cfg.name}: tokens {tuple(run['tokens'].shape)}")
    check(tuple(logits.shape) == (batch, cfg.vocab) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), f"{cfg.name}: last logits not finite float32 (B, V)")
    check(bool(((run["tokens"] >= 0) & (run["tokens"] < cfg.vocab)).all()), f"{cfg.name}: token ids")
    return run, {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
        "compute_dtype": cfg.compute_dtype, "batch": batch, "prompt": prompt, "decode_steps": steps,
        "prefill_ms": run["prefill_s"] * 1e3, "prefill_tok_s": batch * prompt / run["prefill_s"],
        "decode_ms_per_step": run["decode_s"] * 1e3 / steps,
        "decode_tok_s": batch * steps / run["decode_s"],
        "peak_device_bytes": torch.cuda.max_memory_allocated() - before,
        "continuation_ids": run["tokens"][0, :12].tolist(),
    }


def decode_consistency(run: dict, cfg) -> float:
    """Decode of the first greedy token after a prefill over the prompt,
    against a prefill over the prompt and that token: max |gap| over the
    largest |logit|."""
    params, inputs = run["params"], run["inputs"]
    B, S = inputs["tokens"].shape
    logits, caches = lm.prefill(params, inputs, cfg, cache_len=S + 1)
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    dec, _ = lm.decode_step(params, nxt, torch.full((B,), S, device=nxt.device), caches, inputs, cfg)
    want, _ = lm.prefill(params, dict(inputs, tokens=torch.cat([inputs["tokens"], nxt], 1)), cfg)
    return float((dec - want).abs().max() / want.abs().max())


def moe_drops(run: dict, cfg) -> dict:
    """The first MoE layer's router on its normed input of the prompt's
    embeddings: both dispatch modes' keep masks (bit for bit) and both
    modes' layer outputs."""
    params, tokens = run["params"], run["inputs"]["tokens"]
    bp = next(b for b in params["blocks"] if "moe" in b)
    x = lm._embed_tokens(params, tokens, cfg)
    h = norm_apply(lm._norm_kind(cfg), bp["norm2"], x, cfg.norm_eps)
    E, C = cfg.moe.num_experts, lm_moe.capacity(tokens.shape[1], cfg.moe)
    ids, _, _, _ = lm_moe.router_topk(bp["moe"], h, cfg.moe)
    _, meta = lm_moe.dispatch_remap(h, ids, E, C)
    _, keep = lm_moe.onehot_slots(ids, E, C)
    remap_keep = torch.empty_like(meta["keep"]).scatter_(-1, meta["perm"], meta["keep"])
    check(torch.equal(remap_keep, keep), f"{cfg.name}: remap and onehot drop different assignments")
    outs = [lm_moe.moe_apply(bp["moe"], h, dataclasses.replace(cfg.moe, dispatch=d), cfg.act)[0].float()
            for d in ("remap", "onehot")]
    return {"capacity": C, "assignments": keep.numel(), "dropped": int((~keep).sum()),
            "keep_masks_equal": True,
            "remap_vs_onehot_max_rel_gap": float((outs[0] - outs[1]).abs().max() / outs[1].abs().max())}


def device_profile(fn, reps: int) -> dict:
    """`fn` timed `reps` times by the host clock (synchronized), then run
    `reps` more times under torch.profiler: per call, the host ms, the CUDA
    kernels launched and their device ms, the device's idle share of the
    unprofiled host time, and the kernels taking the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    device_ms = sum(sum(v) for v in by_name.values()) / reps
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:PROFILE_TOP]
    return {"reps": reps, "host_ms": host_ms, "kernels": len(kernels) / reps,
            "device_ms": device_ms if kernels else None,
            "device_idle_share": (1 - device_ms / host_ms) if kernels else None,
            "top": [{"kernel": name[:90], "per_call": len(v) / reps, "ms": sum(v) / reps} for name, v in top]}


def serve_profiles(run: dict, cfg) -> dict:
    """Prefills and decode steps of a served model, PROFILE_REPS of each
    timed and PROFILE_REPS profiled (`device_profile`)."""
    params, inputs = run["params"], run["inputs"]
    B, S = inputs["tokens"].shape
    state = {}

    def prefill():
        state["logits"], state["caches"] = lm.prefill(params, inputs, cfg, cache_len=S + 2 * PROFILE_REPS)

    pre = device_profile(prefill, PROFILE_REPS)
    nxt = torch.argmax(state["logits"], -1).to(torch.int32)[:, None]
    pos = torch.full((B,), S, device=nxt.device)

    def step():
        lm.decode_step(params, nxt, pos, state["caches"], inputs, cfg)
        pos.add_(1)

    return {"prefill": pre, "decode_step": device_profile(step, PROFILE_REPS)}


def serving_phase() -> dict:
    """Phase n: the LM stack's serving path on the card (no decomposition
    kernel on it: the counters stay 0).  qwen3-0.6b at full width and depth
    through `launch.serve.serve` (a warm-up run, then the measured one),
    its float32 re-run's decode-after-prefill gap, and every other family
    at full width with its depth cut."""
    phase_t0 = time.perf_counter()
    reset_launches()
    cfg = get_config(SERVE_ARCH)
    served(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_WARMUP_TOKENS)
    run, main_path = served(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW)
    main_path["profile"] = serve_profiles(run, cfg)
    del run
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    run, f32 = served(cfg32, SERVE_BATCH, SERVE_PROMPT, SERVE_WARMUP_TOKENS)
    gap = decode_consistency(run, cfg32)
    check(gap <= TOL_DECODE, f"{SERVE_ARCH} float32: decode after prefill {gap} > {TOL_DECODE}")
    del run
    families = []
    for arch, layers in FAMILY_LAYERS.items():
        full = get_config(arch)
        for mode in (("remap", "onehot") if arch == BOTH_DISPATCH else (None,)):
            cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
            if mode is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=mode))
            served(cfg, FAMILY_BATCH, FAMILY_PROMPT, 2)  # warm-up: the first calls' set-up
            run, row = served(cfg, FAMILY_BATCH, FAMILY_PROMPT, FAMILY_DECODE_STEPS + 1)
            row.update({"full_n_layers": full.n_layers, "dispatch": mode,
                        "decode_profile": serve_profiles(run, cfg)["decode_step"]})
            if mode == "remap":
                row["moe_drops"] = moe_drops(run, cfg)
            families.append(row)
            del run
    launches = (mttkrp_blocked.launches, ttmc_blocked.launches, ttcore_blocked.launches)
    check(launches == (0, 0, 0), f"the serving path launched decomposition kernels: {launches}")
    emit({"phase": "n", "nvidia_smi": nvidia_smi(), "phase_s": time.perf_counter() - phase_t0,
          "main_path": main_path, "float32_rerun": {**f32, "decode_after_prefill_max_rel_gap": gap,
                                                    "tol": TOL_DECODE},
          "families": families, "decomposition_kernel_launches": list(launches)})
    return main_path



def param_rel_gaps(a, b, cfg) -> dict[str, float]:
    """Per parameter leaf (the reference's names): max |a - b| over the
    largest |b|, of two train states."""
    fa, fb = (dict(numpy_leaves(train_state_to_numpy(x, cfg)["params"])) for x in (a, b))
    return {k: float(np.abs(fa[k].astype(np.float64) - fb[k]).max() / max(np.abs(fb[k]).max(), 1e-30))
            for k in fb}


def numpy_leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from numpy_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from numpy_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def opt_for(cfg, lr: float) -> AdamWConfig:
    """launch.train's optimizer: bfloat16 moments for fsdp archs."""
    return AdamWConfig(lr=lr, warmup_steps=2, total_steps=100, state_dtype="bfloat16" if cfg.fsdp else "float32")


@contextlib.contextmanager
def optimizer_input(into: dict):
    """Record the gradient tree each train step hands AdamW (after the
    microbatches' accumulation) into `into`."""
    real = train_step_mod.adamw_update

    def spy(params, grads, state, cfg, **kw):
        into.update(grads)
        return real(params, grads, state, cfg, **kw)

    train_step_mod.adamw_update = spy
    try:
        yield into
    finally:
        train_step_mod.adamw_update = real


def stub_memory(cfg, batch: dict, seed: int, index: int) -> dict:
    """The batch with the memory stream its family reads (whisper frames,
    vision patches; 0.1 x standard normal from (seed, index)), else as is:
    the token pipeline carries none."""
    if cfg.family not in ("audio", "vlm"):
        return batch
    B = batch["tokens"].shape[0]
    rng = np.random.default_rng((seed, index, 1))
    key, rows = ("frames", cfg.encoder_seq) if cfg.family == "audio" else ("images", cfg.img_tokens)
    return dict(batch, **{key: (rng.standard_normal((B, rows, cfg.d_model), np.float32) * 0.1)})


def trained(cfg, steps: int, batch: int, seq: int, lr: float = TRAIN_LR, seed: int = TRAIN_SEED,
            **step_kw) -> tuple:
    """`steps` steps of the port's train step on cuda:0 from `seed` (the
    parameters and the batches): (the state, {losses, lrs, ms per step,
    peak device bytes over what was allocated before})."""
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = opt_for(cfg, lr)
    state = init_train_state(cfg, opt, generator=torch.Generator("cuda").manual_seed(seed), device="cuda",
                             compress_grads=step_kw.get("compress_grads", False))
    step = make_train_step(cfg, opt, **step_kw)
    pipe = TokenPipeline(cfg.vocab, seq, batch, seed=seed)
    losses, lrs, ms = [], [], []
    for i in range(steps):
        b = stub_memory(cfg, pipe.batch(i), seed, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        lrs.append(float(metrics["lr"]))
    return state, {"losses": losses, "lrs": lrs, "ms": ms,
                   "peak_device_bytes": torch.cuda.max_memory_allocated() - before}


def train_main_path() -> tuple[dict, list]:
    """qwen3-0.6b through launch.train as a user runs it, then profiled."""
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    args = launch_train.parse_args(TRAIN_MAIN_ARGS)
    out: dict = {}
    t0 = time.perf_counter()
    launch_train.train_once(args, 0, out)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["ms"] for h in hist[TRAIN_MEDIAN_FROM:])
    failures = []
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        failures.append(f"{TRAIN_ARCH} main path: losses {losses} not finite and falling")
    cfg, _, _, step_fn, pipe = launch_train.build(args)
    state = out.pop("state")
    batch = pipe.batch(args.steps)

    def one_step():
        step_fn(state, batch)

    profile = device_profile(one_step, TRAIN_PROFILE_STEPS)
    del state, out
    tokens = args.batch * args.seq
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
            "compute_dtype": cfg.compute_dtype, "remat": cfg.remat, "batch": args.batch, "seq": args.seq,
            "microbatches": args.microbatches, "lr": args.lr, "warmup": args.warmup, "steps": args.steps,
            "losses": losses, "lr_per_step": [h["lr"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist], "step_ms": [h["ms"] for h in hist],
            "median_step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
            "peak_device_bytes": peak, "train_once_s": wall_s, "profile": profile}, failures


def train_cpu_parity() -> tuple[dict, list]:
    """The reduced config in float32: the card against the CPU from one state."""
    cfg = get_config(TRAIN_ARCH).reduced()
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=30)
    cpu = init_train_state(cfg, opt, generator=torch.Generator("cpu").manual_seed(TRAIN_SEED), device="cpu")
    gpu = train_state_from_numpy(train_state_to_numpy(cpu, cfg), cfg, "cuda")
    step = make_train_step(cfg, opt, attn_chunk=8)
    pipe = TokenPipeline(cfg.vocab, 32, 8, seed=TRAIN_SEED)
    losses = {"cuda": [], "cpu": []}
    for i in range(TRAIN_CPU_STEPS):
        for dev, st in (("cuda", gpu), ("cpu", cpu)):
            _, m = step(st, pipe.batch(i))
            losses[dev].append(float(m["loss"]))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    gaps = param_rel_gaps(gpu, cpu, cfg)
    worst = max(gaps, key=gaps.get)
    failures = []
    if loss_gap > TOL_TRAIN_LOSS:
        failures.append(f"reduced float32: card against CPU losses {losses} gap {loss_gap}")
    if gaps[worst] > TOL_TRAIN_PARAM:
        failures.append(f"reduced float32: card against CPU parameter {worst} gap {gaps[worst]}")
    return {"steps": TRAIN_CPU_STEPS, "losses": losses, "max_loss_rel_gap": loss_gap,
            "max_param_rel_gap": gaps[worst], "worst_leaf": worst,
            "leaves_over_1e-5": sorted(k for k, v in gaps.items() if v > 1e-5)}, failures


def train_self_checks() -> tuple[dict, list]:
    """Full width in float32: remat on against off, 2 microbatches against
    1 after one step, and int8 error feedback."""
    cfg32 = dataclasses.replace(get_config(TRAIN_ARCH), compute_dtype="float32")
    B, S = 8, 512
    failures = []
    remat = {}
    for on in (True, False):
        state, row = trained(dataclasses.replace(cfg32, remat=on), TRAIN_SELF_STEPS, B, S, num_microbatches=2)
        remat["on" if on else "off"] = row
        del state
    remat_gap = max(abs(a - b) / abs(b) for a, b in zip(remat["on"]["losses"], remat["off"]["losses"]))
    if remat_gap > TOL_TRAIN_LOSS:
        failures.append(f"float32 remat on against off: losses gap {remat_gap}")
    microbatches = []
    for seed in TRAIN_MB_SEEDS:
        row, f = microbatches_2_vs_1(cfg32, B, S, seed)
        microbatches.append(row)
        failures += f
    state, comp = trained(cfg32, TRAIN_COMPRESS_STEPS, B, S, num_microbatches=2, compress_grads=True)
    ef_abs_max = max(float(t.abs().max()) for leaf in state.opt["ef"].values()
                     for t in (leaf if isinstance(leaf, list) else [leaf]))
    del state
    if not (all(math.isfinite(x) for x in comp["losses"]) and comp["losses"][-1] < comp["losses"][0]):
        failures.append(f"float32 int8 error feedback: losses {comp['losses']} not finite and falling")
    return {"batch": B, "seq": S, "remat": {**remat, "max_loss_rel_gap": remat_gap},
            "microbatches_2_vs_1": {"tol_grad": TOL_TRAIN_GRAD, "tol_sharp_param": TOL_TRAIN_PARAM,
                                    "sharp_over_grad_gap": TRAIN_MB_SHARP, "by_seed": microbatches},
            "compress_grads": {**comp, "ef_abs_max": ef_abs_max}}, failures


def microbatches_2_vs_1(cfg, B: int, S: int, seed: int) -> tuple[dict, list]:
    """One step from `seed` with 2 microbatches and with 1: the gradients
    AdamW receives, and the parameters after the step held to Adam's first
    step (see TRAIN_MB_SHARP)."""
    states, grads, lrs = {}, {}, {}
    for n in (1, 2):
        with optimizer_input(grads.setdefault(n, {})):
            states[n], row = trained(cfg, 1, B, S, seed=seed, num_microbatches=n)
        lrs[n] = row["lrs"][0]
    lr = lrs[1]
    p1, p2 = (train_step_mod.master_leaves(states[n].params, cfg) for n in (1, 2))
    ggap, over_2lr, sharp_gap = {}, {}, {}
    n_sharp, n_all = 0, 0
    for k in grads[1]:
        g1s, g2s = members(grads[1][k]), members(grads[2][k])
        delta = max(float((b - a).abs().max()) for a, b in zip(g1s, g2s))
        ggap[k] = delta / max(max(float(g.abs().max()) for g in g1s), 1e-30)
        pmax = max(float(p.abs().max()) for p in members(p1[k]))
        over_2lr[k], sharp_gap[k] = 0.0, 0.0
        for a, b, g in zip(members(p1[k]), members(p2[k]), g1s):
            d = (b - a).abs()
            over_2lr[k] = max(over_2lr[k], float(d.max()) / (2 * lr + 2.0**-21 * pmax))
            sharp = g.abs() >= TRAIN_MB_SHARP * delta
            n_sharp, n_all = n_sharp + int(sharp.sum()), n_all + g.numel()
            if sharp.any():
                sharp_gap[k] = max(sharp_gap[k], float(d[sharp].max()) / max(pmax, 1e-30))
    del states, grads, p1, p2
    gworst, bworst, sworst = (max(x, key=x.get) for x in (ggap, over_2lr, sharp_gap))
    failures = []
    if lrs[1] != lrs[2]:
        failures.append(f"2 microbatches against 1 (seed {seed}): lr {lrs}")
    if ggap[gworst] > TOL_TRAIN_GRAD:
        failures.append(f"float32 2 microbatches against 1 (seed {seed}): gradient {gworst} gap {ggap[gworst]}")
    if over_2lr[bworst] > 1.0:
        failures.append(f"float32 2 microbatches against 1 (seed {seed}): parameter {bworst} moved "
                        f"{over_2lr[bworst]} times 2 lr")
    if sharp_gap[sworst] > TOL_TRAIN_PARAM:
        failures.append(f"float32 2 microbatches against 1 (seed {seed}): parameter {sworst} gap "
                        f"{sharp_gap[sworst]} where its gradient is sharp")
    return {"seed": seed, "lr": lr, "max_grad_rel_gap": ggap[gworst], "worst_grad_leaf": gworst,
            "max_param_gap_over_2lr": over_2lr[bworst], "worst_leaf_over_2lr": bworst,
            "max_sharp_param_rel_gap": sharp_gap[sworst], "worst_sharp_leaf": sworst,
            "sharp_share": n_sharp / n_all}, failures


def train_families() -> tuple[list, list, list]:
    rows, failures = [], []
    for arch, layers in TRAIN_FAMILIES.items():
        full = get_config(arch)
        modes = ("remap", "onehot") if arch == BOTH_DISPATCH else (None,)
        for mode in modes:
            cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
            if mode is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=mode))
            state, row = trained(cfg, TRAIN_FAMILY_STEPS, TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ, lr=TRAIN_FAMILY_LR)
            n = sum(p.numel() for p in state.params.parameters())
            row.update({"arch": arch, "lr": TRAIN_FAMILY_LR, "falling": row["losses"][-1] < row["losses"][0],
                        "n_layers": cfg.n_layers, "full_n_layers": full.n_layers, "dispatch": mode,
                        "params": n, "fsdp": cfg.fsdp, "median_step_ms": statistics.median(row["ms"][1:]),
                        "tokens_per_s": TRAIN_FAMILY_BATCH * TRAIN_FAMILY_SEQ / (statistics.median(row["ms"][1:]) / 1e3)})
            if mode == "remap":
                tokens = torch.as_tensor(TokenPipeline(cfg.vocab, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_BATCH,
                                                       seed=TRAIN_SEED).batch(0)["tokens"], device="cuda")
                with torch.no_grad():
                    row["moe_drops"] = moe_drops({"params": state.params, "inputs": {"tokens": tokens}}, cfg)
            if not all(math.isfinite(x) for x in row["losses"]):
                failures.append(f"{arch} ({mode}): losses {row['losses']} not finite")
            rows.append(row)
            del state
    skipped = []
    for arch, layers in TRAIN_NOT_ON_ONE_CARD.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        n = sum(p.numel() for p in lm.abstract_params(cfg).parameters())
        skipped.append({"arch": arch, "n_layers": layers, "params": n, "bytes_at_14_per_param": n * 14,
                        "card_bytes": CARD_BYTES,
                        "why": "one period (or layer) with its embeddings and its optimizer state exceeds one "
                               "card: it needs the optimizer sharded over several cards (the mesh slice)"})
    return rows, skipped, failures


def leaf_kind(name: str) -> str:
    """A parameter leaf's name without its layer ("blocks.7.attn.wq" ->
    "attn.wq")."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "blocks" and parts[1].isdigit() else name


def family_gradients() -> tuple[list, list]:
    """The families' loss and gradients on the card against the CPU (see
    FAMILY_GRAD_BATCH)."""
    rows, failures = [], []
    for arch, layers in TRAIN_FAMILIES.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        depth = FAMILY_GRAD_LAYERS.get(arch, layers)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth, encoder_layers=min(depth, cfg.encoder_layers))
        cfg = dataclasses.replace(cfg, compute_dtype="float32", remat=False)
        # One state drawn on the card; its parameters alone are copied to
        # the CPU (the gradients read nothing of the optimizer's).
        drawn = init_train_state(cfg, AdamWConfig(factored_v=True), generator=torch.Generator("cuda").manual_seed(
            TRAIN_SEED), device="cuda")
        t1 = time.perf_counter()
        host = lm.abstract_params(cfg).to_empty(device="cpu")
        host.load_state_dict(drawn.params.state_dict())
        params = {"cuda": drawn.params, "cpu": host}
        del drawn, host
        seconds = {"to_cpu": time.perf_counter() - t1}
        batch = stub_memory(cfg, TokenPipeline(cfg.vocab, FAMILY_GRAD_SEQ, FAMILY_GRAD_BATCH, seed=TRAIN_SEED).batch(0),
                            TRAIN_SEED, 0)
        losses, grads = {}, {}
        for dev in ("cuda", "cpu"):
            t1 = time.perf_counter()
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            loss, _, g = train_step_mod.value_and_grad(cfg, train_step_mod.cast_leaves(params.pop(dev), cfg), b)
            losses[dev], grads[dev] = float(loss), g
            del b
            seconds[dev] = time.perf_counter() - t1
        gaps = {}
        with torch.no_grad():
            for name, want in grads["cpu"].items():
                want = want.to("cuda")
                gaps[name] = float((grads["cuda"][name] - want).abs().max() / want.abs().max().clamp_min(1e-30))
                del want
        del grads
        torch.cuda.empty_cache()
        loss_gap = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        if loss_gap > TOL_TRAIN_LOSS:
            failures.append(f"{arch} float32 card against CPU: losses {losses} gap {loss_gap}")
        by_kind: dict[str, float] = {}
        for name, gap in gaps.items():
            by_kind[leaf_kind(name)] = max(by_kind.get(leaf_kind(name), 0.0), gap)
        bound = {k: FAMILY_GRAD_NAMED.get((arch, k), TOL_FAMILY_GRAD) for k in by_kind}
        over = {k: v for k, v in by_kind.items() if v > bound[k]}
        if over:
            failures.append(f"{arch} float32 card against CPU: gradients over their bounds {over}")
        rows.append({"arch": arch, "n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
                     "batch": FAMILY_GRAD_BATCH, "seq": FAMILY_GRAD_SEQ, "losses": losses, "loss_rel_gap": loss_gap,
                     "leaves": len(gaps), "max_grad_rel_gap_by_kind": by_kind,
                     "median_grad_rel_gap": statistics.median(gaps.values()), "s": time.perf_counter() - t0,
                     "s_by_device": seconds})
    return rows, failures


def training_phase() -> dict:
    """Phase o: the LM stack's training path on the card (no decomposition
    kernel on it: the counters stay 0).  Every number is emitted before any
    failed check raises."""
    phase_t0 = time.perf_counter()
    reset_launches()
    main_path, failures = train_main_path()
    cpu, f = train_cpu_parity()
    failures += f
    self_checks, f = train_self_checks()
    failures += f
    families, not_trained, f = train_families()
    failures += f
    t0 = time.perf_counter()
    family_grads, f = family_gradients()
    failures += f
    family_grads_s = time.perf_counter() - t0
    launches = (mttkrp_blocked.launches, ttmc_blocked.launches, ttcore_blocked.launches)
    if launches != (0, 0, 0):
        failures.append(f"the training path launched decomposition kernels: {launches}")
    emit({"phase": "o", "nvidia_smi": nvidia_smi(), "phase_s": time.perf_counter() - phase_t0,
          "main_path": main_path, "card_vs_cpu": {**cpu, "tol_loss": TOL_TRAIN_LOSS, "tol_param": TOL_TRAIN_PARAM},
          "full_width_float32": self_checks, "families": families, "not_trained": not_trained,
          "families_card_vs_cpu": {"rows": family_grads, "s": family_grads_s, "tol_loss": TOL_TRAIN_LOSS,
                                   "tol_grad": TOL_FAMILY_GRAD,
                                   "named": {f"{a} {k}": v for (a, k), v in FAMILY_GRAD_NAMED.items()}},
          "decomposition_kernel_launches": list(launches), "failures": failures})
    check(not failures, "; ".join(failures))
    return main_path


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def on_mesh(t, mesh) -> bool:
    """Whether `t` is a DTensor on `mesh` (the same ranks and axis names)."""
    from repro_torch.dist.sharding import is_dtensor

    return (is_dtensor(t) and t.device_mesh.mesh.tolist() == mesh.mesh.tolist()
            and t.device_mesh.mesh_dim_names == mesh.mesh_dim_names)


def mesh_train_run() -> tuple[dict, list]:
    """launch.train.main on the mesh, the gradient tree AdamW receives
    checked at each step (every leaf a DTensor on the mesh)."""
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out: dict = {}
    off_grads: set = set()  # gradients off the mesh at any step (names only: no tensor is held)
    real = train_step_mod.adamw_update

    def spy(params, grads, state, cfg, **kw):
        mesh_ = next(iter(state["m"].values()))
        mesh_ = (mesh_[0] if isinstance(mesh_, list) else mesh_).device_mesh
        off_grads.update(k for k, g in grads.items() for t in members(g) if not on_mesh(t, mesh_))
        return real(params, grads, state, cfg, **kw)

    t0 = time.perf_counter()
    train_step_mod.adamw_update = spy
    try:
        rc = launch_train.main(MESH_TRAIN_ARGS, out)
    finally:
        train_step_mod.adamw_update = real
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    check(rc == 0, f"launch.train.main on the mesh returned {rc}")
    mesh, state, hist = out["mesh"], out["state"], out["history"]
    check(mesh is not None and tuple(mesh.shape) == (1, 1), f"launch.train ran off the mesh: {mesh}")
    losses = [h["loss"] for h in hist]
    failures = []
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        failures.append(f"mesh main path: losses {losses} not finite and falling")
    params = dict(state.params.named_parameters())
    off = sorted(k for k, p in params.items() if not on_mesh(p, mesh))
    if off or off_grads:
        failures.append(f"not DTensors on the mesh: parameters {off[:4]}, gradients {sorted(off_grads)[:4]}")
    del state, out
    return {"losses": losses, "step_ms": [h["ms"] for h in hist],
            "median_step_ms": statistics.median(h["ms"] for h in hist[MESH_MEDIAN_FROM:]),
            "peak_device_bytes": peak, "main_s": wall_s, "parameters_checked": len(params),
            "all_dtensors_on_mesh": not (off or off_grads)}, failures


def mesh_against_plain(mesh) -> tuple[dict, list]:
    """MESH_HELD_STEPS steps from seed TRAIN_SEED on the mesh and off it,
    then MESH_TURNS steps of each in turns and one of each profiled."""
    from repro_torch.dist.sharding import make_plan

    args = launch_train.parse_args(MESH_TRAIN_ARGS)
    cfg, _, opt, _, pipe = launch_train.build(args)
    cfg = dataclasses.replace(cfg, remat=True)
    plan = make_plan(mesh, cfg)
    states, steps, losses = {}, {}, {}
    for name, pl in (("plain", None), ("mesh", plan)):
        kw = {} if pl is None else {"plan": pl}
        states[name] = init_train_state(cfg, opt, generator=torch.Generator("cuda").manual_seed(TRAIN_SEED),
                                        device="cuda", **kw)
        steps[name] = make_train_step(cfg, opt, *([] if pl is None else [pl]), num_microbatches=args.microbatches,
                                      attn_chunk=args.attn_chunk)
        losses[name] = [float(steps[name](states[name], pipe.batch(i))[1]["loss"]) for i in range(MESH_HELD_STEPS)]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"], losses["plain"]))
    gaps = device_param_gaps(states["mesh"].params, states["plain"].params)
    worst = max(gaps, key=gaps.get)
    failures = []
    if loss_gap > TOL_MESH:
        failures.append(f"mesh against plain: losses {losses} gap {loss_gap}")
    if gaps[worst] > TOL_MESH:
        failures.append(f"mesh against plain: parameter {worst} gap {gaps[worst]}")
    batch = pipe.batch(MESH_HELD_STEPS)
    turns = {"plain": [], "mesh": []}
    for _ in range(MESH_TURNS):
        for name in ("plain", "mesh"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(steps[name](states[name], batch)[1]["loss"])
            turns[name].append((time.perf_counter() - t0) * 1e3)
    profile = device_profile(lambda: steps["mesh"](states["mesh"], batch), 1)  # the plain step's: phase o's
    profile.pop("top", None)
    del states
    return {"held_steps": MESH_HELD_STEPS, "losses": losses, "max_loss_rel_gap": loss_gap,
            "max_param_rel_gap": gaps[worst], "worst_leaf": worst, "tol": TOL_MESH,
            "step_ms_in_turns": turns, "mesh_step_profile": profile}, failures


def device_param_gaps(mesh_params, plain_params) -> dict[str, float]:
    """Per parameter (the port's names): max |mesh - plain| over the
    largest |plain|, on the card (the mesh's DTensors gathered whole)."""
    from repro_torch.dist.sharding import full

    plain = dict(plain_params.named_parameters())
    out = {}
    for k, p in mesh_params.named_parameters():
        want = plain[k].detach()
        out[k] = float((full(p.detach()) - want).abs().max() / want.abs().max().clamp(min=1e-30))
    return out


def mesh_serve_run() -> tuple[dict, list]:
    """launch.serve.main on the mesh and the plain `serve`, in turns."""
    cfg = get_config(SERVE_ARCH)
    runs = {"plain": [], "mesh": []}
    tokens = {}
    peaks = {}
    for _ in range(2):
        for name in ("plain", "mesh"):
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if name == "mesh":
                out: dict = {}
                check(launch_serve_main(MESH_SERVE_ARGS, out) == 0, "launch.serve.main on the mesh failed")
                check(out["mesh"] is not None, "launch.serve ran off the mesh")
            else:
                out = serve(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, new_tokens=MESH_SERVE_NEW,
                            seed=SERVE_SEED, device="cuda")
            peaks[name] = torch.cuda.max_memory_allocated() - before
            tokens[name] = out["tokens"].cpu()
            runs[name].append({"prefill_ms": out["prefill_s"] * 1e3,
                               "decode_ms_per_step": out["decode_s"] * 1e3 / (MESH_SERVE_NEW - 1)})
            del out
    failures = []
    if not torch.equal(tokens["mesh"], tokens["plain"]):
        failures.append("mesh serving: greedy tokens differ from the plain path's")
    return {"batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "new_tokens": MESH_SERVE_NEW, "in_turns": runs,
            "peak_device_bytes": peaks, "tokens_equal": not failures,
            "continuation_ids": tokens["mesh"][0, :12].tolist()}, failures


def mesh_phase(serve_main_path: dict | None, train_main_path: dict | None) -> int:
    """Phase p: the LM stack's mesh path on a one-rank NCCL group (no
    decomposition kernel on it: the counters stay 0), beside phase n's and
    o's main paths where given.  A failure of the group or the mesh fails
    the run: nothing here falls back to the plain path.  Returns the mesh
    run's peak device bytes (phase q's bar)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    phase_t0 = time.perf_counter()
    reset_launches()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_host_mesh(1, 1)
        check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
              and mesh.mesh_dim_names == ("data", "model"), f"make_host_mesh(1, 1) gave {mesh}")
        parts_s = {}
        t0 = time.perf_counter()
        train, failures = mesh_train_run()
        parts_s["train"] = time.perf_counter() - t0
        held, f = mesh_against_plain(mesh)
        parts_s["held_and_turns"] = time.perf_counter() - t0 - parts_s["train"]
        failures += f
        served_, f = mesh_serve_run()
        parts_s["serve"] = time.perf_counter() - t0 - parts_s["train"] - parts_s["held_and_turns"]
        failures += f
    finally:
        dist.destroy_process_group()
    launches = (mttkrp_blocked.launches, ttmc_blocked.launches, ttcore_blocked.launches)
    if launches != (0, 0, 0):
        failures.append(f"the mesh path launched decomposition kernels: {launches}")
    beside = None if train_main_path is None else _beside(serve_main_path, train_main_path)
    emit({"phase": "p", "nvidia_smi": nvidia_smi(), "phase_s": time.perf_counter() - phase_t0,
          "parts_s": parts_s, "mesh": [1, 1], "train_main_path": train, "held_to_plain": held, "serve": served_,
          "beside_phases_n_o": beside, "decomposition_kernel_launches": list(launches), "failures": failures})
    check(not failures, "; ".join(failures))
    return train["peak_device_bytes"]


def _beside(serve_main_path: dict, train_main_path: dict) -> dict:
    """Phase o's and phase n's numbers of this run, for phase p's line."""
    prof_o = train_main_path["profile"]
    return {"phase_o_median_step_ms": train_main_path["median_step_ms"],
              "phase_o_device_ms": prof_o["device_ms"], "phase_o_idle_share": prof_o["device_idle_share"],
              "phase_o_peak_device_bytes": train_main_path["peak_device_bytes"],
              "phase_n_prefill_ms": serve_main_path["prefill_ms"],
              "phase_n_decode_ms_per_step": serve_main_path["decode_ms_per_step"],
              "phase_n_decode_device_ms": serve_main_path["profile"]["decode_step"]["device_ms"],
              "phase_n_peak_device_bytes": serve_main_path["peak_device_bytes"]}


def load_entry(rel: str):
    """A script or example of the checkout as a module, for its main()."""
    import importlib.util

    path = ROOT / rel
    spec = importlib.util.spec_from_file_location("_entry_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_points_phase() -> None:
    """Phase r: every entry point of the port once on the card (see
    CALIBRATE_ARGS).  Each run's exit code, seconds and kernel launches
    are emitted before any failed check raises."""
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    reset_launches()
    runs, failures = [], []

    def run(rel: str, argv: list, out: dict | None = None) -> dict:
        before = (mttkrp_blocked.launches, ttmc_blocked.launches, ttcore_blocked.launches)
        t0 = time.perf_counter()
        mod = load_entry(rel)
        rc = mod.main(argv) if out is None else mod.main(argv, out)
        torch.cuda.synchronize()
        after = (mttkrp_blocked.launches, ttmc_blocked.launches, ttcore_blocked.launches)
        row = {"entry": rel, "argv": argv, "exit": rc, "s": time.perf_counter() - t0,
               "launches": {k: b - a for k, a, b in zip(("mttkrp", "ttmc", "ttcore"), before, after)}}
        runs.append(row)
        if rc != 0:
            failures.append(f"{rel} {' '.join(argv)} exited {rc}")
        return row

    quick = "examples/quickstart_torch.py"
    kernel_of = {"cp": "mttkrp", "tucker": "ttmc", "tt": "ttcore"}
    checks: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "autotune")
        run("scripts/torch_calibrate.py", CALIBRATE_ARGS + ["--cache-dir", cache])
        hit: dict = {}
        run("scripts/torch_calibrate.py", CALIBRATE_ARGS + ["--cache-dir", cache, "--check-hit"], hit)
        checks["calibrate_check_hit"] = hit.get("check_hit")
        if not hit.get("check_hit") or hit["check_hit"]["spec_misses"] or not hit["check_hit"]["spec_hits"]:
            failures.append(f"torch_calibrate --check-hit: spec lookups {hit.get('check_hit')}")

        sharded = {}
        for algo in ("cp", "tucker", "tt"):
            one, two = {}, {}
            row1 = run(quick, ["--fast", "--algo", algo, "--devices", "1"], one)
            run(quick, ["--fast", "--algo", algo, "--devices", "2"], two)
            gap = max(abs(a - b) for a, b in zip(two["sharded_fit_history"], one["fit_history"]))
            sharded[algo] = {"fits_devices_1": one["fit_history"], "sharded_fits_devices_2": two["sharded_fit_history"],
                             "shards": two["shards"], "max_fit_gap": gap}
            if not gap <= TOL_SHARD_FIT:
                failures.append(f"quickstart --algo {algo} --devices 2: sharded fits {two['sharded_fit_history']} "
                                f"against --devices 1's {one['fit_history']}")
            if row1["launches"][kernel_of[algo]] == 0:
                failures.append(f"quickstart --algo {algo} launched no {kernel_of[algo]} kernel: {row1['launches']}")
        checks["sharded"] = sharded

        trace = os.path.join(tmp, "quickstart.jsonl")
        cached = [{}, {}]
        with mock.patch.dict(os.environ, {"REPRO_TORCH_AUTOTUNE_DIR": cache}):
            run(quick, ["--fast", "--auto-tune", "cached"], cached[0])
            run(quick, ["--fast", "--auto-tune", "cached", "--trace", trace], cached[1])
        checks["auto_tune_cached"] = [{k: c.get(k) for k in ("configs_evaluated", "autotune_cache_hits",
                                                             "fit_history", "launches")} for c in cached]
        if not (cached[0]["configs_evaluated"] > 0 and cached[1]["configs_evaluated"] == 0
                and cached[1]["autotune_cache_hits"] > 0):
            failures.append(f"quickstart --auto-tune cached twice: {checks['auto_tune_cached']}")
        run("scripts/torch_trace_report.py", [trace, "--pms"])

        run("examples/train_lm_torch.py", ["--steps", str(ENTRY_TRAIN_LM_STEPS), "--ckpt-dir",
                                           os.path.join(tmp, "train_lm")])
        run("examples/serve_batch_torch.py", [])
        run("examples/fault_tolerance_demo_torch.py", [])
        moe: dict = {}
        run("examples/moe_dispatch_demo_torch.py", [], moe)
        checks["moe_dispatch"] = moe
        if not moe.get("max_abs_diff", math.inf) <= TOL_MOE_MODES:
            failures.append(f"moe_dispatch_demo_torch: remap against onehot {moe.get('max_abs_diff')}")
    torch.cuda.empty_cache()
    emit({"phase": "r", "nvidia_smi": nvidia_smi(), "phase_s": time.perf_counter() - phase_t0, "runs": runs,
          "checks": checks, "tol_shard_fit": TOL_SHARD_FIT, "tol_moe_modes": TOL_MOE_MODES,
          "launches": {"mttkrp": mttkrp_blocked.launches, "ttmc": ttmc_blocked.launches,
                       "ttcore": ttcore_blocked.launches}, "failures": failures})
    check(not failures, "; ".join(failures))


def dryrun_phase(phase_o_peak: int | None, phase_p_peak: int | None) -> None:
    """Phase q: the dry run, in a subprocess (`dryrun_child`) that prints
    the phase's line; a failed check there fails the run here."""
    reset_launches()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=DRY_ALLOC_CONF)
    bars = json.dumps({"phase_o_peak_device_bytes": phase_o_peak, "phase_p_peak_device_bytes": phase_p_peak})
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--dryrun-phase", bars], env=env,
                          timeout=DRY_PHASE_TIMEOUT_S)
    check(proc.returncode == 0, f"phase q exited {proc.returncode}")
    launches = (mttkrp_blocked.launches, ttmc_blocked.launches, ttcore_blocked.launches)
    check(launches == (0, 0, 0), f"phase q launched decomposition kernels: {launches}")


def rounded(sizes) -> int:
    """What the caching allocator hands out for tensors of these sizes
    under expandable segments: each rounded up to ALLOC_ROUND bytes."""
    return sum(-(-n // ALLOC_ROUND) * ALLOC_ROUND for n in sizes if n)


def dry_traced(fn, args) -> dict:
    """`trace_cell` of a cell, checked to allocate nothing on the card."""
    from repro_torch.launch import dryrun

    before = torch.cuda.memory_allocated()
    traced = dryrun.trace_cell(fn, args)
    check(torch.cuda.memory_allocated() == before, "the dry run allocated device memory")
    check(set(traced["device_bytes"]) <= {"meta", "cpu"}, f"the dry run's storages {traced['device_bytes']}")
    return traced


def card_peak(step) -> int:
    """max_memory_allocated() over one `step()` on the card, everything it
    needs already there."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated()


def dry_train_cell(bars: dict, failures: list) -> dict:
    """Phase o's cell: launch.train's step (TRAIN_MAIN_ARGS) on a one-rank
    fake mesh, against phase p's mesh peak and the state on the card."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    args = launch_train.parse_args(TRAIN_MAIN_ARGS)
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    with dryrun.fake_process_group(1):
        cfg, plan, opt, step, _ = launch_train.build(args, make_host_mesh(1, 1, device_type="cuda"))
        state = dryrun.abstract_train_state(cfg, opt, plan)
        traced = dry_traced(step, (state, dryrun.abstract_batch(cfg, shape, plan)))
        del state
    del step, plan
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    state = init_train_state(cfg, opt, generator=torch.Generator("cuda").manual_seed(TRAIN_SEED), device="cuda")
    batch = {k: torch.zeros((args.batch, args.seq), dtype=torch.int32, device="cuda") for k in ("tokens", "labels")}
    state_bytes = torch.cuda.memory_allocated() - before
    del state, batch
    mem = traced["memory"]
    want = rounded(traced["argument_storages"])
    if state_bytes != want:
        failures.append(f"phase o's cell: the state and batch took {state_bytes} B on the card, the dry run's "
                        f"{len(traced['argument_storages'])} arguments {mem['argument_bytes']} B, rounded {want}")
    p_peak = bars["phase_p_peak_device_bytes"]
    gap = None if p_peak is None else mem["peak_bytes"] / p_peak - 1
    if gap is None or abs(gap) > TOL_DRY_TRAIN:
        failures.append(f"phase o's cell: dry-run peak {mem['peak_bytes']} B against phase p's {p_peak} B")
    o_peak = bars["phase_o_peak_device_bytes"]
    return {"args": TRAIN_MAIN_ARGS, "mesh": [1, 1], "memory": mem, "trace_s": traced["trace_s"],
            "collectives": traced["collectives"], "flops": traced["cost"]["flops"],
            "arguments": len(traced["argument_storages"]), "argument_bytes_rounded": want,
            "card_state_and_batch_bytes": state_bytes, "phase_p_peak_device_bytes": p_peak, "gap_to_phase_p": gap,
            "phase_o_peak_device_bytes": o_peak,
            "gap_to_phase_o": None if o_peak is None else mem["peak_bytes"] / o_peak - 1, "tol": TOL_DRY_TRAIN}


def dry_serve_cells(failures: list) -> dict:
    """Phase n's serving shape in bfloat16: the prefill and decode cells
    dry-run on a one-rank fake mesh, and each step once on the card."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    cache_len = SERVE_PROMPT + SERVE_NEW
    shapes = {"prefill": ShapeConfig("prefill", SERVE_PROMPT, SERVE_BATCH, "prefill"),
              "decode": ShapeConfig("decode", cache_len, SERVE_BATCH, "decode")}
    traced = {}
    with dryrun.fake_process_group(1):
        mesh = make_host_mesh(1, 1, device_type="cuda")
        for kind, shape in shapes.items():
            fn, args, info = dryrun.build_cell(SERVE_ARCH, shape, mesh, cache_len=cache_len)
            traced[kind] = dry_traced(fn, args)
            del fn, args
    cfg = info["cfg"]  # bfloat16 parameters
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(SERVE_SEED)
    params = lm.init_params(cfg, generator=gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), generator=gen, device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    card = {"prefill": card_peak(lambda: prefill(params, {"tokens": tokens}))}
    caches = lm.init_caches(cfg, SERVE_BATCH, cache_len, device="cuda")
    new = tokens[:, -1:].contiguous()
    pos = torch.full((SERVE_BATCH,), SERVE_PROMPT, dtype=torch.int64, device="cuda")
    decode = make_decode_step(cfg)
    card["decode"] = card_peak(lambda: decode(params, new, pos, caches, {}))
    del params, caches, tokens, new, pos
    torch.cuda.empty_cache()
    out = {}
    for kind, t in traced.items():
        gap = t["memory"]["peak_bytes"] / card[kind] - 1
        if abs(gap) > TOL_DRY_SERVE:
            failures.append(f"{kind}: dry-run peak {t['memory']['peak_bytes']} B against {card[kind]} B on the card")
        out[kind] = {"memory": t["memory"], "trace_s": t["trace_s"], "card_peak_device_bytes": card[kind],
                     "gap": gap, "collectives": t["collectives"], "flops": t["cost"]["flops"]}
    return {"arch": SERVE_ARCH, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "cache_len": cache_len,
            "param_dtype": cfg.param_dtype, "tol": TOL_DRY_SERVE, **out}


def dry_cli_cells(failures: list) -> list:
    """DRY_CELLS through the dry run's command line, as a user runs it."""
    total = torch.cuda.get_device_properties(0).total_memory
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape in DRY_CELLS:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                                   "--out", tmp], capture_output=True, text=True, timeout=DRY_CELL_TIMEOUT_S,
                                  env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
            wall_s = time.perf_counter() - t0
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[dryrun]")]
            path = Path(tmp) / f"{arch}__{shape}__single.json"
            rec = json.loads(path.read_text()) if path.is_file() else {}
            if proc.returncode != 0 or not rec.get("ok"):
                failures.append(f"dryrun {arch} {shape}: exit {proc.returncode}, {lines or proc.stderr[-400:]}")
            mem = rec.get("memory", {})
            out.append({"arch": arch, "shape": shape, "exit": proc.returncode, "line": lines, "wall_s": wall_s,
                        "ok": rec.get("ok"), "trace_s": rec.get("trace_s"),
                        "mesh_device_type": rec.get("mesh_device_type"),
                        "peak_bytes_per_device": mem.get("peak_bytes"), "argument_bytes": mem.get("argument_bytes"),
                        "card_total_memory": total,
                        "collectives": {k: v["count"] for k, v in rec.get("collectives", {}).items()}})
    return out


def dryrun_child(bars: dict) -> int:
    """Phase q's body, in its own process: prints the phase's line, exits
    non-zero on a failed check."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_t0 = time.perf_counter()
    failures: list = []
    parts_s = {}
    t0 = time.perf_counter()
    train = dry_train_cell(bars, failures)
    parts_s["train_cell"] = time.perf_counter() - t0
    serve_cells = dry_serve_cells(failures)
    parts_s["serve_cells"] = time.perf_counter() - t0 - parts_s["train_cell"]
    cli = dry_cli_cells(failures)
    parts_s["production_cells"] = time.perf_counter() - t0 - parts_s["train_cell"] - parts_s["serve_cells"]
    if dist.is_initialized():
        failures.append("the dry run left a process group running")
    launches = (mttkrp_blocked.launches, ttmc_blocked.launches, ttcore_blocked.launches)
    if launches != (0, 0, 0):
        failures.append(f"the dry run launched decomposition kernels: {launches}")
    emit({"phase": "q", "nvidia_smi": nvidia_smi(), "phase_s": time.perf_counter() - phase_t0, "parts_s": parts_s,
          "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"), "train_cell": train, "serve_cells": serve_cells,
          "production_cells": cli, "decomposition_kernel_launches": list(launches), "failures": failures})
    return 1 if failures else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-phase"]:
        sys.exit(dryrun_child(json.loads(sys.argv[2])))
    sys.exit(main())
