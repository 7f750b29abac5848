"""Where the TT-core kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_ttcore_probe.py [--source LABEL=PATH ...] [--out FILE]

At NELL-2's published size (the synthetic stand-in of chip_smoke.py, TT
ranks (16, 16), default plan geometry) this measures, with CUDA events:

* each TT-core kernel source given (default: the checkout's
  `csrc/ttcore.cu`), whole and in copies with phases cut out of the
  source text: the counting sort alone, the sort and the chains (no column
  phase), and the sort and the column phase (no chains).  The copies are
  written and built under `build/probe/<label>/` beside copies of the
  source directory's headers (else the checkout's `csrc/*.cuh`); the kernel in the checkout is not
  changed.  chains = (sort + chains) - sort; columns = whole - (sort +
  chains).  The cut copies compute wrong results and serve only as timers;
  the whole copy is checked against the float64 plain version;
* the L2 gather rate: a gather kernel reading 1 KB rows of a 9,184 x 256
  float32 matrix (W_1's size, 9.4 MB) picked by the mode-1 index of every
  non-zero in the mode-0 and mode-2 plans' slot order, each warp with 1 or
  4 rows in flight, 16-byte loads, neighbouring lanes on neighbouring
  addresses;
* further copies made by text replacement (`EDITS`): for a kernel that
  stages rows through a cp.async ring, without the ring's copies, without
  its arithmetic, with 2 ring buffers per warp, with 2 and 128-slot steps,
  and with rows read from L2 instead; for the register-path kernel, with
  the warp-per-slot path in place of the register path and the float4
  copies, with 64-column slices in place of row parts, without the column
  phase's atomics, with one column per thread, and with the compiler held
  to 1 or 3 CTAs per SM instead of 4;
* one `torch.profiler` trace of a TT-core launch, to see whether it reports
  device time on this machine.

Prints one JSON line per measurement and writes them all to --out
(default `build/probe/ttcore_probe.json`).  Needs a
CUDA device and nvcc, as chip_smoke.py does; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core.coo import synthetic_tensor  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mttkrp import rank_padded  # noqa: E402
from repro_torch.kernels.tt import ttcore_blocked, ttcore_blocked_plain  # noqa: E402
from repro_torch.tt.als import make_planned_tt  # noqa: E402

NELL2_SHAPE = (12_092, 9_184, 28_818)
NELL2_NNZ = 76_879_419
NELL2_SKEW = 1.1
TT_RANKS = (16, 16)
REPS = 10
PROBE_DIR = ROOT / "build" / "probe"

# Phase cuts by source text: (start anchor, end anchor); the text from the
# start anchor up to (not including) the end anchor is removed, so the end
# anchor's statement keeps the start anchor's indentation.  One set per
# kernel layout; a source takes the first set whose anchors it all holds.
CUTS = {
    # The first CUDA design: chain groups of `lanes` threads per slot, then the
    # column phase.
    "chain_groups": {
        "chains": ("for (int j0 = 0; j0 < count; j0 += chains) {",
                   "__syncthreads();  // staged vectors complete"),
        "columns": ("if (active) {\n        // Only a segment's first",
                    "__syncthreads();  // the step's sums are in the tile"),
    },
    # Later kernels: one call per phase, each on a line of its own.
    "phase_calls": {
        "chains": ("stage_chains<N_IN>(a, count,", "__syncthreads();  // staged vectors complete"),
        "columns": ("add_columns(a, s_tile,", "__syncthreads();  // the step's sums are in the tile"),
    },
}
VARIANTS = {"whole": (), "sort_chains": ("columns",), "sort_columns": ("chains",),
            "sort": ("chains", "columns")}
# Further copies by text replacement, each (old, new) pair applied once; a
# copy is made only from a source that holds every `old` text.  For a source
# with a cp.async staging ring: what the ring's copies, its arithmetic, its
# depth, the step's size and L2 reads instead of the ring cost.  For the
# register-path kernel: the warp-per-slot path instead of the register path
# and the float4 row copies; 64-column slices instead of row parts (chains
# redone per slice); plain adds instead of the column phase's atomics (a
# wrong result, timed only); one column per thread instead of 4; the
# compiler held to 1 or 3 CTAs per SM instead of 4 (at most 255 or 85
# registers instead of 64).
EDITS = {
    "ring_no_copies": [("if (t < mine) issue(t);", ";"),
                       ("if (t + a.ring - 1 < mine) issue(t + a.ring - 1);", ";")],
    "ring_no_arith": [("chain_slot<N_IN>(a, j, [&](int n) { return buf + a.off[n]; }, s_val[j], "
                       "s_stage, va, vb, lane);", ";")],
    "ring2": [("for (int depth = 4; depth >= 2; depth /= 2)", "for (int depth = 2; depth >= 2; depth /= 2)")],
    "ring2_chunk128": [("for (int depth = 4; depth >= 2; depth /= 2)", "for (int depth = 2; depth >= 2; depth /= 2)"),
                       ("static_cast<int>(fit) : kChunk;", "static_cast<int>(fit) : 128;")],
    "direct": [("  if (!a.copy) {\n    for (int depth", "  if (false) {\n    for (int depth")],
    "warp_path": [("a.group = !a.copy && vec &&", "a.group = false &&"),
                  ("a.copy4 = a.copy && vec &&", "a.copy4 = false &&")],
    "column_slices": [("  const int max_slice = a.quad_cols ? 4 * kThreads : kThreads;",
                       "  const int max_slice = 64;")],
    "cols_no_atomics": [("  if (shared) {\n#pragma unroll\n    for (int k = 0; k < CW; ++k) atomicAdd",
                         "  if (false) {\n#pragma unroll\n    for (int k = 0; k < CW; ++k) atomicAdd")],
    "cols_scalar": [("  a.quad_cols = rr_m % 4 == 0;", "  a.quad_cols = 0;")],
    "min_ctas_1": [("constexpr int kMinCtasPerSm = 4;", "constexpr int kMinCtasPerSm = 1;")],
    "min_ctas_3": [("constexpr int kMinCtasPerSm = 4;", "constexpr int kMinCtasPerSm = 3;")],
}

GATHER_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Each warp takes U rows at a time (rows of row4 float4s); every lane issues
// all of its loads for the U rows before it adds any of them.
template <int U>
__global__ void gather_rows(const float4* __restrict__ w, const int64_t* __restrict__ rows,
                            int64_t n, int row4, float* out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  float acc = 0.0f;
  for (int64_t i0 = warp * U; i0 < n; i0 += warps * U) {
    float4 x[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = i0 + u;
      const float4* r = w + (i < n ? rows[i] : 0) * row4;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = lane + 32 * k;
        x[u][k] = (i < n && e < row4) ? __ldg(r + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 2; ++k) acc += x[u][k].x + x[u][k].y + x[u][k].z + x[u][k].w;
  }
  out[warp * 32 + lane] = acc;
}
extern "C" int gather_launch(const void* w, const void* rows, long long n, int row4, void* out,
                             int u, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u == 1) {
    gather_rows<1><<<grid, 256, 0, s>>>(static_cast<const float4*>(w),
        static_cast<const int64_t*>(rows), n, row4, static_cast<float*>(out));
  } else {
    gather_rows<4><<<grid, 256, 0, s>>>(static_cast<const float4*>(w),
        static_cast<const int64_t*>(rows), n, row4, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def emit(rec: dict, sink: list) -> None:
    sink.append(rec)
    print(json.dumps(rec), flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nvcc(src: Path, lib: Path) -> Path:
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(out.stdout + out.stderr)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stdout}{out.stderr}")
    return lib


def cut(text: str, phases) -> str:
    for layout, cuts in CUTS.items():
        if all(a in text and b in text for a, b in cuts.values()):
            for ph in phases:
                start, end = cuts[ph]
                i = text.index(start)
                text = text[:i] + text[text.index(end, i):]
            return text
    raise ValueError("the source matches no known kernel layout: no phase cuts for it")


def variant_libs(label: str, src: Path) -> dict[str, ctypes.CDLL]:
    """Build the whole source and its cut and edited copies, beside copies
    of the headers in the source's directory (the checkout's csrc/ headers
    where it has none); return {variant: library}."""
    out_dir = PROBE_DIR / label
    out_dir.mkdir(parents=True, exist_ok=True)
    headers = sorted(src.parent.glob("*.cuh")) or sorted(build.CSRC_DIR.glob("*.cuh"))
    for header in headers:
        (out_dir / header.name).write_text(header.read_text())
    text = src.read_text()
    sources = {name: cut(text, phases) for name, phases in VARIANTS.items()}
    for name, reps in EDITS.items():
        if all(old in text for old, _ in reps):
            var = text
            for old, new in reps:
                var = var.replace(old, new, 1)
            sources[name] = var
    libs, procs = {}, []
    for name, var in sources.items():
        path = out_dir / f"ttcore_{name}.cu"
        path.write_text(var)
        lib = path.with_suffix(".so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(path)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label} {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def with_library(lib: ctypes.CDLL):
    """Make the TT-core wrapper launch from `lib` until the next call."""
    build.load = lambda name: lib  # the wrapper imports `load` at call time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a ttcore.cu to split (repeatable); default: the checkout's")
    ap.add_argument("--out", default=str(PROBE_DIR / "ttcore_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ttcore_probe: needs a CUDA device", file=sys.stderr)
        return 1
    sources = [s.split("=", 1) for s in args.source] or [["current", str(build.CSRC_DIR / "ttcore.cu")]]
    recs: list = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"probe": "device", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}, recs)

    t0 = time.perf_counter()
    built = {label: variant_libs(label, Path(path)) for label, path in sources}
    emit({"probe": "build", "s": time.perf_counter() - t0, "sources": dict(sources)}, recs)

    st = synthetic_tensor(NELL2_SHAPE, NELL2_NNZ, seed=0, skew=NELL2_SKEW)
    ws = make_planned_tt(st, TT_RANKS, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    real_load = build.load
    for m, op in ws.ops.items():
        plan, pairs, n_left = op.plan, op.in_rank_pairs, op.n_left
        mats = [torch.randn((rows, rank_padded(a * b)), generator=gen, device="cuda")
                for rows, (a, b) in zip(plan.in_rows, pairs)]
        exact = ttcore_blocked_plain(dataclasses.replace(plan, vals=plan.vals.double()),
                                     [w.double() for w in mats], pairs, n_left)
        scale = exact.abs().amax(0).clamp_min(1e-300)
        for label, libs in built.items():
            times = {}
            # In turns: whole, cuts, whole again (the spread of one variant).
            extra = [k for k in libs if k not in VARIANTS]
            for name in ["whole", "sort", "sort_chains", "sort_columns", *extra, "whole"]:
                with_library(libs[name])
                ms = cuda_ms(lambda: ttcore_blocked(plan, mats, pairs, n_left))
                times.setdefault(name, []).append(ms)
            with_library(libs["whole"])
            got = ttcore_blocked(plan, mats, pairs, n_left)
            err = float(((got.double() - exact).abs().amax(0) / scale).max())
            build.load = real_load
            t = {k: min(v) for k, v in times.items()}
            emit({"probe": "split", "source": label, "mode": m, "in_rank_pairs": list(pairs),
                  "ms": times, "sort_ms": t["sort"], "chains_ms": t["sort_chains"] - t["sort"],
                  "columns_ms": t["whole"] - t["sort_chains"],
                  "columns_without_chains_ms": t["sort_columns"] - t["sort"],
                  **{f"{k}_ms": t[k] for k in extra},
                  "whole_max_rel_err": err}, recs)
            del got
        del mats, exact

    # L2 gather rate over W_1-sized rows in the plans' own slot order.
    glib = ctypes.CDLL(str(nvcc(_write(PROBE_DIR / "l2_gather.cu", GATHER_SRC),
                                PROBE_DIR / "l2_gather.so")))
    glib.gather_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    glib.gather_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w1 = torch.randn((NELL2_SHAPE[1], 256), generator=gen, device="cuda")
    for m in (0, 2):
        plan = ws.ops[m].plan
        n = plan.in_modes.index(1)
        rows = (plan.block_in[n].long().repeat_interleave(plan.blk) * plan.in_tiles[n]
                + plan.in_locs[n].long())[plan.vals != 0].contiguous()
        for u in (1, 4):
            for per_sm in (8, 16):
                grid = sms * per_sm
                out = torch.empty(grid * 256, device="cuda")

                def go():
                    err = glib.gather_launch(w1.data_ptr(), rows.data_ptr(), rows.numel(), 64,
                                             out.data_ptr(), u, grid,
                                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"gather launch failed: {err}")

                ms = cuda_ms(go)
                emit({"probe": "l2_gather", "plan_mode": m, "rows": rows.numel(), "row_bytes": 1024,
                      "rows_in_flight_per_warp": u, "ctas_per_sm": per_sm, "ms": ms,
                      "gb_per_s": rows.numel() * 1024 / ms / 1e6}, recs)
        del rows

    # One profiler trace of the checkout's kernel on mode 0.
    op = ws.ops[0]
    mats = [torch.randn((rows, rank_padded(a * b)), generator=gen, device="cuda")
            for rows, (a, b) in zip(op.plan.in_rows, op.in_rank_pairs)]
    ttcore_blocked(op.plan, mats, op.in_rank_pairs, op.n_left)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            ttcore_blocked(op.plan, mats, op.in_rank_pairs, op.n_left)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.0)
        rows.append({"name": e.key[:80], "count": e.count, "device_time_total_us": dev,
                     "cpu_time_total_us": e.cpu_time_total})
    rows.sort(key=lambda r: -r["device_time_total_us"])
    emit({"probe": "profiler", "events": rows[:8]}, recs)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    print(smi, flush=True)
    return 0


def _write(path: Path, text: str) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


if __name__ == "__main__":
    sys.exit(main())
