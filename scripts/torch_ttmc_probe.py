"""Where the TTMc kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_ttmc_probe.py [--source LABEL=PATH ...] [--out FILE]

At NELL-2's published size (the synthetic stand-in of chip_smoke.py, core
ranks (16, 16, 16): 256 output columns on every mode, default plan
geometry) this measures, with CUDA events:

* each TTMc kernel source given (default: the checkout's `csrc/ttmc.cu`),
  whole and in copies with phases cut out of the source text or edited,
  written and built under `build/probe/<label>/` beside copies of the
  source directory's headers (else the checkout's `csrc/*.cuh`); the kernel
  in the checkout is not changed.  The cut copies compute wrong results and
  serve only as timers; the whole copy is checked against the float64
  plain version.
  - A kernel that stages every step's slots in shared memory (the design
    kept in `scripts/probe_kernels/ttmc_pr16.cu`): `sort` keeps the field
    reads, the counting sort and the loop (no gather, no products);
    `sort_gather` adds the staging gather; `no_flush` is the whole kernel
    with the tile's global atomics left out.  So: field reads and sort =
    sort; gather = sort_gather - sort; products and tile read-modify-writes
    = whole - sort_gather - flushes; flushes = whole - no_flush.
  - A kernel that sorts each range once and holds rows in registers (the
    checkout's design): `sort` keeps the two passes of the range sort (no
    row work); `rows_no_flush` leaves out the output reductions;
    `rows_no_loads` takes numbers made from the row indices in place of the
    factor loads; `rows_coalesced_fields` reads the slot fields in stream
    order (rows made up, 64 slots each) instead of through the sort's
    permutation; `sort_4096`, `sort_16384` sort chunks of 4,096 or 16,384
    slots instead of 8,192; `stream_evict_first` reads the stream fields
    with an evict-first hint (`__ldcs`); `ctas_2`, `ctas_3` leave the
    compiler registers for 2 or 3 CTAs per SM instead of 4.  So: sort =
    sort; rows = whole - sort - flushes; flushes = whole - rows_no_flush;
    factor loads = whole - rows_no_loads; field gathers = whole -
    rows_coalesced_fields.
* the row-run lengths of each mode's plan: the real (non-zero) slots of
  one row within one 256-slot step, and within one block range of 64
  blocks (the kernels' ranges at this size), counted with plain torch on
  the plan tensors.

Prints one JSON line per measurement and writes them all to --out
(default `build/probe/ttmc_probe.json`).  Needs a CUDA device and nvcc, as
chip_smoke.py does; imports nothing of JAX.
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
sys.path.insert(0, str(ROOT / "scripts"))
from repro_torch.core.coo import synthetic_tensor  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mttkrp import rank_padded  # noqa: E402
from repro_torch.kernels.ttm import ttmc_blocked, ttmc_blocked_plain  # noqa: E402
from repro_torch.tucker.hooi import make_planned_tucker  # noqa: E402
from torch_ttcore_probe import cuda_ms, emit, with_library  # noqa: E402

NELL2_SHAPE = (12_092, 9_184, 28_818)
NELL2_NNZ = 76_879_419
NELL2_SKEW = 1.1
CORE_RANKS = (16, 16, 16)
PROBE_DIR = ROOT / "build" / "probe"
STEP = 256          # slots per step of the staged design
RANGE_BLOCKS = 64   # blocks per range at this size (ceil(nblocks / 64) ranges fill the card)

# Phase cuts by source text: (start anchor, end anchor); the text from the
# start anchor up to (not including) the end anchor is removed.  One set per
# kernel layout; a source takes the first set whose anchors it all holds.
CUTS = {
    "staged_steps": {
        "gather": ("      for (int l = lane_id; l < a.sum_r; l += 32) {",
                   "      __syncthreads();  // staged lanes complete"),
        "products": ("      if (active) {\n        // Only a segment's first",
                     "      __syncthreads();  // the step's sums are in the tile; staging is free"),
    },
    "range_sort": {
        "rows": ("      warp_rows<N_IN, NQ>(a,", "      __syncthreads();  // the edges are free"),
    },
}
VARIANTS = {
    "staged_steps": {"whole": (), "sort": ("gather", "products"), "sort_gather": ("products",)},
    "range_sort": {"whole": (), "sort": ("rows",)},
}
# Edits by text replacement, every occurrence; a copy is made only from a
# source that holds every `old` text.
CLEAR_TILE = """#include "blocked.cuh"

template <class Args>
__device__ __forceinline__ void clear_tile(const Args& a, float* s_tile) {
  for (int i = threadIdx.x; i < a.tile_i * a.slice; i += kThreads) s_tile[i] = 0.0f;
}
"""
EDITS = {
    "no_flush": [('#include "blocked.cuh"\n', CLEAR_TILE),
                 ("flush_tile(a, s_tile, cur_tile)", "clear_tile(a, s_tile)")],
    # The reductions left out, the sums kept alive by a store that never runs.
    "rows_no_flush": [("atomicAdd(reinterpret_cast<float4*>(dst), acc[k]);",
                       "if (acc[k].x == 1.2345e-30f) dst[0] = acc[k].y;")],
    # Numbers made from the row indices in place of the factor loads.
    "rows_no_loads": [("here ? __ldg(a.factors[n] + static_cast<int64_t>(in[n]) * a.ld[n] + g.dig[k][n]) : 0.0f;",
                       "here ? static_cast<float>(in[n]) : 0.0f;"),
                      ("x[k] = __ldg(reinterpret_cast<const float4*>(src));",
                       "x[k] = make_float4(static_cast<float>(in[N_IN - 1]), 1.0f, 2.0f, 3.0f);")],
    "rows_coalesced_fields": [("    const int64_t s = s0 + s_perm[p];", "    const int64_t s = s0 + p;"),
                              ("    f.row = a.iloc[s];", "    f.row = p >> 6;")],
    "sort_4096": [("constexpr int kSortSlots = 8192;", "constexpr int kSortSlots = 4096;")],
    "sort_16384": [("constexpr int kSortSlots = 8192;", "constexpr int kSortSlots = 16384;")],
    "stream_evict_first": [("a.vals[s0 + o]", "__ldcs(a.vals + s0 + o)"),
                           ("a.iloc[s0 + o]", "__ldcs(a.iloc + s0 + o)"),
                           ("f.row = a.iloc[s];", "f.row = __ldcs(a.iloc + s);"),
                           ("f.val = a.vals[s];", "f.val = __ldcs(a.vals + s);"),
                           ("a.in_locs[n][s]", "__ldcs(a.in_locs[n] + s)")],
    "ctas_2": [("constexpr int kMinCtasPerSm = 4;", "constexpr int kMinCtasPerSm = 2;")],
    "ctas_3": [("constexpr int kMinCtasPerSm = 4;", "constexpr int kMinCtasPerSm = 3;")],
}


def layout_of(text: str) -> str:
    for layout, cuts in CUTS.items():
        if all(a in text and b in text for a, b in cuts.values()):
            return layout
    raise ValueError("the source matches no known kernel layout: no phase cuts for it")


def cut(text: str, layout: str, phases) -> str:
    for ph in phases:
        start, end = CUTS[layout][ph]
        i = text.index(start)
        text = text[:i] + text[text.index(end, i):]
    return text


def variant_libs(label: str, src: Path) -> dict[str, ctypes.CDLL]:
    """Build the whole source and its cut and edited copies in parallel,
    beside copies of the headers in the source's directory (the checkout's
    csrc/ headers where it has none); return {variant: library}."""
    out_dir = PROBE_DIR / label
    out_dir.mkdir(parents=True, exist_ok=True)
    headers = sorted(src.parent.glob("*.cuh")) or sorted(build.CSRC_DIR.glob("*.cuh"))
    for header in headers:
        (out_dir / header.name).write_text(header.read_text())
    text = src.read_text()
    layout = layout_of(text)
    sources = {name: cut(text, layout, phases) for name, phases in VARIANTS[layout].items()}
    for name, reps in EDITS.items():
        if all(old in text for old, _ in reps):
            var = text
            for old, new in reps:
                var = var.replace(old, new)
            sources[name] = var
    libs, procs = {}, []
    for name, var in sources.items():
        path = out_dir / f"ttmc_{name}.cu"
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


def phases(t: dict[str, float]) -> dict[str, float]:
    """The phase split of one source's variant times (ms, least of each)."""
    if "sort_gather" in t:
        flush = t["whole"] - t["no_flush"]
        return {"sort_ms": t["sort"], "gather_ms": t["sort_gather"] - t["sort"],
                "products_ms": t["whole"] - t["sort_gather"] - flush, "flush_ms": flush}
    out = {"sort_ms": t["sort"]}
    if "rows_no_flush" in t:
        flush = t["whole"] - t["rows_no_flush"]
        out.update(rows_ms=t["whole"] - t["sort"] - flush, flush_ms=flush)
    if "rows_no_loads" in t:
        out["factor_loads_ms"] = t["whole"] - t["rows_no_loads"]
    if "rows_coalesced_fields" in t:
        out["field_gathers_ms"] = t["whole"] - t["rows_coalesced_fields"]
    out.update({f"{k}_ms": t[k] for k in ("sort_4096", "sort_16384", "stream_evict_first", "ctas_2",
                                          "ctas_3") if k in t})
    return out


def run_lengths(plan) -> dict:
    """Real slots per (step, row) and per (range, row): how long the row
    runs of a sort over one step, or over one block range, are."""
    real = plan.vals != 0
    slot = torch.arange(plan.vals.numel(), device=plan.vals.device)[real]
    block = slot // plan.blk
    row = plan.block_it.long()[block] * plan.tile_i + plan.iloc.long()[real]
    steps_per_block = -(-plan.blk // STEP)
    step = block * steps_per_block + (slot % plan.blk) // STEP
    out = {}
    for name, unit in (("step", step), ("range", block // RANGE_BLOCKS)):
        _, counts = torch.unique(unit * plan.out_rows + row, return_counts=True)
        c = counts.double()
        q = torch.quantile(c[torch.randperm(c.numel(), device=c.device)[: 1 << 24]],
                           torch.tensor([0.5, 0.9, 0.99], device=c.device, dtype=torch.float64))
        units = int(torch.unique(unit).numel())
        out[name] = {
            "units": units, "runs": int(c.numel()), "slots": int(c.sum()),
            "runs_per_unit": c.numel() / units,
            "mean": float(c.mean()), "slot_weighted_mean": float((c * c).sum() / c.sum()),
            "p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2]), "max": int(c.max()),
            "runs_of_1": float((c == 1).double().mean()),
            "slots_in_runs_of_1": float(c[c == 1].sum() / c.sum()),
        }
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a ttmc.cu to split (repeatable); default: the checkout's")
    ap.add_argument("--out", default=str(PROBE_DIR / "ttmc_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ttmc_probe: needs a CUDA device", file=sys.stderr)
        return 1
    sources = [s.split("=", 1) for s in args.source] or [["current", str(build.CSRC_DIR / "ttmc.cu")]]
    recs: list = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"probe": "device", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}, recs)

    t0 = time.perf_counter()
    built = {label: variant_libs(label, Path(path)) for label, path in sources}
    emit({"probe": "build", "s": time.perf_counter() - t0, "sources": dict(sources),
          "ptxas": {label: [ln.strip() for ln in (PROBE_DIR / label / "ttmc_whole.log").read_text()
                            .splitlines() if "registers" in ln or "spill" in ln]
                    for label, _ in sources}}, recs)

    st = synthetic_tensor(NELL2_SHAPE, NELL2_NNZ, seed=0, skew=NELL2_SKEW)
    ws = make_planned_tucker(st, CORE_RANKS, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    real_load = build.load
    for m, op in ws.ops.items():
        plan, in_ranks = op.plan, op.in_ranks
        emit({"probe": "run_lengths", "mode": m, **run_lengths(plan)}, recs)
        facs = [torch.randn((rows, rank_padded(r)), generator=gen, device="cuda")
                for rows, r in zip(plan.in_rows, in_ranks)]
        exact = ttmc_blocked_plain(dataclasses.replace(plan, vals=plan.vals.double()),
                                   [f.double() for f in facs], in_ranks)
        scale = exact.abs().amax(0).clamp_min(1e-300)
        for label, libs in built.items():
            times: dict[str, list[float]] = {}
            # In turns: whole, the other variants, whole again (the spread).
            for name in ["whole", *(k for k in libs if k != "whole"), "whole"]:
                with_library(libs[name])
                times.setdefault(name, []).append(cuda_ms(lambda: ttmc_blocked(plan, facs, in_ranks)))
            with_library(libs["whole"])
            got = ttmc_blocked(plan, facs, in_ranks)
            err = float(((got.double() - exact).abs().amax(0) / scale).max())
            build.load = real_load
            t = {k: min(v) for k, v in times.items()}
            emit({"probe": "split", "source": label, "mode": m, "in_ranks": list(in_ranks),
                  "ms": times, **phases(t), "whole_max_rel_err": err}, recs)
            del got
        del facs, exact

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
