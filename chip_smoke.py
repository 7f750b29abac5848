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
              16 and at rank 256, which takes column slices) and on
              every mode of the NELL-2-size tensor; CUDA vs CPU CP-ALS fits
              on a small tensor; kernel, plain and sweep timings
  d  main     decompose(st, 16, format="cp", iters=5, seed=0) with the launch
              counters reset just before and read just after
  e  check    TTMc kernel vs plain version on 3-, 4- and 5-mode presets with
              mixed core ranks, on a (200, 200, 200) tensor at core ranks
              (100, 8, 100) and on every mode of the NELL-2-size tensor at
              core ranks (16, 16, 16); CUDA vs CPU HOOI fits on a small
              tensor; kernel, plain, sweep and sweep-part timings
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

then the `kernels` line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero before that line.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.api import decompose  # noqa: E402
from repro_torch.core.coo import frostt_like, synthetic_tensor  # noqa: E402
from repro_torch.core.cp_als import fit_value  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mttkrp import mttkrp_blocked, mttkrp_blocked_plain, rank_padded  # noqa: E402
from repro_torch.kernels.ops import _tt_bond_pairs, make_planned_cp_als  # noqa: E402
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

RANK = 16
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


def reset_launches() -> None:
    mttkrp_blocked.launches = 0
    ttmc_blocked.launches = 0
    ttcore_blocked.launches = 0


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
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in libs.values() if Path(str(lib) + ".log").is_file()
             for ln in Path(str(lib) + ".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "b", "build_s": build_s, "libraries": sorted(libs), "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(0)
    rp = rank_padded(RANK)
    presets, wide = [], []
    for preset in PRESETS:
        st = frostt_like(preset)
        for rank, out in ((RANK, presets), (WIDE_RANK, wide)):
            ws = make_planned_cp_als(st, rank, device="cuda")
            for m in range(st.nmodes):
                plan = ws.plan_for(m)
                facs = random_padded(plan, [rank_padded(rank)] * plan.n_in, gen)
                out.append({"preset": preset, "rank": rank, "mode": m, "n_in": plan.n_in,
                            **check_kernel(mttkrp_blocked, mttkrp_blocked_plain, plan, facs,
                                           tol=TOL_PRESET, what=f"{preset} rank {rank} mode {m}")})
            del ws

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
    modes = []
    for m in range(st.nmodes):
        plan = ws.plan_for(m)
        facs = random_padded(plan, [rp] * plan.n_in, gen)
        errs = check_kernel(mttkrp_blocked, mttkrp_blocked_plain, plan, facs,
                            tol=TOL_FULL, what=f"NELL-2 mode {m}")
        bound_ms, bound_by = bound(st.shape, st.nnz, m, RANK)
        modes.append({
            "mode": m, "nblocks": plan.nblocks, "slots": plan.nblocks * plan.blk,
            "padding": plan.padding_fraction(), "output_tile_runs": plan.output_tile_runs(),
            **errs,
            "ms": cuda_ms(lambda: mttkrp_blocked(plan, facs), KERNEL_REPS),
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
    emit({"phase": "c", "presets": presets, "wide": wide, "tiny_fit_gap_cuda_cpu": fit_gap,
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
          "kernel_ms": [x["ms"] for x in modes], "plain_ms": [x["plain_ms"] for x in modes],
          "bound_ms": [x["bound_ms"] for x in modes]})

    del state
    torch.cuda.empty_cache()
    tucker = tucker_phases(st, gen)
    torch.cuda.empty_cache()
    tt = tt_phases(st, gen)

    emit({"kernels": [{
        "name": "mttkrp_blocked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mttkrp.cu",
        "replaces": "src/repro/kernels/mttkrp_pallas.py:53 _kernel",
        "launches": launches,
        "per": f"one sweep: {st.nmodes} launches, one per mode",
        "max_abs_err": max(x["max_abs_err"] for x in modes),
        "max_rel_err": max(x["max_rel_err"] for x in modes),
        "ms": sum(x["ms"] for x in modes),
        "plain_ms": sum(x["plain_ms"] for x in modes),
        "bound_ms": sum(x["bound_ms"] for x in modes),
        "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in modes) else "operations",
        "library_ms": None,
    }, tucker, tt]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def tucker_phases(st, gen: torch.Generator) -> dict:
    """Phases e and f on the NELL-2-size tensor `st`; returns the TTMc
    kernel's entry of the `kernels` line."""
    presets = []
    for preset, core_ranks in PRESET_CORE_RANKS.items():
        small = frostt_like(preset)
        ws = make_planned_tucker(small, core_ranks, device="cuda")
        for m, op in ws.ops.items():
            facs = random_padded(op.plan, [rank_padded(r) for r in op.in_ranks], gen)
            presets.append({"preset": preset, "mode": m, "in_ranks": list(op.in_ranks),
                            **check_kernel(ttmc_blocked, ttmc_blocked_plain, op.plan, facs,
                                           op.in_ranks, tol=TOL_PRESET, what=f"{preset} mode {m}")})
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
        modes.append({
            "mode": m, "in_ranks": list(op.in_ranks), "cols": op.out_cols, **errs,
            "ms": cuda_ms(lambda: ttmc_blocked(plan, facs, op.in_ranks), KERNEL_REPS),
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
    emit({"phase": "e", "presets": presets, "wide": wide, "tiny_fit_gap_cuda_cpu": fit_gap,
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
        "plain_ms": sum(x["plain_ms"] for x in modes),
        "bound_ms": sum(x["bound_ms"] for x in modes),
        "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in modes) else "operations",
        "library_ms": None,
    }


def tt_phases(st, gen: torch.Generator) -> dict:
    """Phases g and h on the NELL-2-size tensor `st`; returns the TT-core
    kernel's entry of the `kernels` line."""
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
        "plain_ms": sum(x["plain_ms"] for x in modes),
        "bound_ms": sum(x["bound_ms"] for x in modes),
        "bound_by": "bytes" if all(x["bound_by"] == "bytes" for x in modes) else "operations",
        "library_ms": None,
    }


if __name__ == "__main__":
    sys.exit(main())
