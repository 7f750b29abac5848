"""Where the MTTKRP kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_mttkrp_probe.py [--source LABEL=PATH ...] [--out FILE]

At NELL-2's published size (the synthetic stand-in of chip_smoke.py, CP
rank 16, default plan geometry) this measures, with CUDA events, each
MTTKRP kernel source given (default: the checkout's `csrc/mttkrp.cu`),
whole and in copies with phases cut out of the source text or edited,
written and built under `build/probe/<label>/<variant>/` beside copies of
the source directory's headers (else the checkout's `csrc/*.cuh`; an edit
applies to them too); the kernel in the checkout is not changed.  The cut copies compute wrong results and serve
only as timers; the whole copy is checked against the float64 plain
version.

* A kernel that compacts each 256-slot chunk in shared memory and sums a
  tile there with shared-memory atomics (the design kept in
  `scripts/probe_kernels/mttkrp_pr17.cu`): `compact` keeps the stream
  reads, the compaction and the barriers (no products); `no_tile_atomics`
  sums each thread's products in a register that is never written out
  (gathers and products, no tile atomics); `no_flush` leaves out the
  flushes' global atomics; `no_loads` takes numbers made from the factor
  offsets in place of the factor gathers; `ranges_64` launches ranges of at
  most 64 blocks instead of one wave of long ones; `ctas_6`, `ctas_8` leave
  the compiler registers for 6 or 8 CTAs per SM.  So: compaction =
  compact; gathers = no_tile_atomics - compact; flushes = whole - no_flush;
  tile atomics = whole - no_tile_atomics - flushes.
* A kernel that sorts each block range's slots by row, their fields into
  shared memory, and sums rows in registers, a group of lanes per slot
  (the checkout's design): `sort` keeps the two passes of the sort, the
  second with the field reads (no row work), and `count` the first pass
  and the scan alone; `warp_aggregated` counts and places with one
  shared-memory atomic per row and warp (as the TTMc kernel does) instead
  of one per slot;
  `rows_no_flush` leaves out
  the output reductions; `rows_no_loads` takes numbers made from the
  factor rows' indices in place of the factor loads; `sort_1024`,
  `sort_4096` sort chunks of 1,024 or 4,096 slots instead of 2,048;
  `sorted_ctas_3`, `sorted_ctas_6` leave the compiler registers
  for 3 or 6 CTAs per SM instead of 4; `place_unroll_8` reads 8 rounds of the placing
  pass at once instead of 4; `groups_2` takes a 16-column row in groups of
  2 lanes with 2 quads each instead of 4 with 1; `no_edges` keeps the
  groups' edges but never walks or adds them; `phase_clocks` has thread 0 of each
  CTA read the SM clock after each of a chunk's barriers, and reports each
  phase's share of the CTAs' cycles in one launch (`phase_cycle_share`:
  count pass with the last chunk's edge walk, scan, placing pass, rows with
  the warps' edge walks).  So: sort = sort; rows =
  whole - sort - flushes; flushes = whole - rows_no_flush; factor loads =
  whole - rows_no_loads; edges = whole - no_edges; placing pass = sort -
  count.

Prints one JSON line per measurement and writes them all to --out
(default `build/probe/mttkrp_probe.json`).  Needs a CUDA device and nvcc,
as chip_smoke.py does; imports nothing of JAX.
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
from repro_torch.kernels.mttkrp import mttkrp_blocked, mttkrp_blocked_plain, rank_padded  # noqa: E402
from repro_torch.kernels.ops import make_planned_cp_als  # noqa: E402
from torch_ttcore_probe import cuda_ms, emit, with_library  # noqa: E402

NELL2_SHAPE = (12_092, 9_184, 28_818)
NELL2_NNZ = 76_879_419
NELL2_SKEW = 1.1
RANK = 16
PROBE_DIR = ROOT / "build" / "probe"
NEVER = "1.2345e-30f"  # a value no sum takes: keeps a cut sum alive without a store
PHASES = ("count", "scan", "place", "rows")

# Phase cuts by source text: (start anchor, end anchor); the text from the
# start anchor up to (not including) the end anchor is removed.  One set per
# kernel layout; a source takes the first set whose anchors it all holds.
CUTS = {
    "tile_compaction": {
        "products": ("      const int items = s_count * width;",
                     "      __syncthreads();  // the compacted list and the tile are complete"),
    },
    "range_sort": {
        "rows": ("      Runs<NQ> runs = group_rows<N_IN, G, NQ>(a,", "      __syncthreads();  // the chunk's rows are done"),
        "place_rows": ("      sort_pass<true, kPlaceUnroll", "      __syncthreads();  // the chunk's rows are done"),
        "edges": ("      pending = out_row0;", "    }\n    b = e;"),
    },
}
VARIANTS = {
    "tile_compaction": {"whole": (), "compact": ("products",)},
    "range_sort": {"whole": (), "sort": ("rows", "edges"), "count": ("place_rows", "edges")},
}
# Edits by text replacement, every occurrence; a copy is made only from a
# source that holds every `old` text.
EDITS = {
    # The tile kernel: products summed in a register, no tile atomics.
    "no_tile_atomics": [
        ("      const int items = s_count * width;",
         "      float acc = 0.0f;\n      const int items = s_count * width;"),
        ("        atomicAdd(&s_tile[s_row[k] + c], p);", "        acc += p;"),
        ("      __syncthreads();  // the compacted list and the tile are complete",
         f"      if (acc == {NEVER}) s_val[0] = acc;\n"
         "      __syncthreads();  // the compacted list and the tile are complete")],
    "no_flush": [("      atomicAdd(dst + static_cast<int64_t>(r) * a.ld + (i - r * width), x);",
                  f"      if (x == {NEVER}) dst[r] = x;")],
    "no_loads": [("          p *= __ldg(a.factors[n] + s_in[n][k] + c);",
                  "          p *= static_cast<float>(s_in[n][k] + c);")],
    "ranges_64": [("mttkrp_blocked_kernel<N_IN, true>", "mttkrp_blocked_kernel<N_IN, true>"),  # this kernel only
                  ("  if (ranges < 1) ranges = 1;\n  if (ranges > a.nblocks)",
                   "  if (ranges < (a.nblocks + 63) / 64) ranges = (a.nblocks + 63) / 64;\n"
                   "  if (ranges < 1) ranges = 1;\n  if (ranges > a.nblocks)")],
    "ctas_6": [("__global__ void __launch_bounds__(kThreads) mttkrp_blocked_kernel",
                "__global__ void __launch_bounds__(kThreads, 6) mttkrp_blocked_kernel")],
    "ctas_8": [("__global__ void __launch_bounds__(kThreads) mttkrp_blocked_kernel",
                "__global__ void __launch_bounds__(kThreads, 8) mttkrp_blocked_kernel")],
    # The range-sort kernel: no reductions, the sums kept alive by a store
    # that never runs.
    "rows_no_flush": [("atomicAdd(reinterpret_cast<float4*>(dst), v);",
                       f"if (v.x == {NEVER}) dst[0] = v.y;")],
    # Numbers made from the row indices in place of the factor loads.
    "rows_no_loads": [("x[n][k] = __ldg(reinterpret_cast<const float4*>(src));",
                       "x[n][k] = make_float4(static_cast<float>(in[n]), 1.0f, 2.0f, 3.0f);")],
    # One shared-memory atomic per row and warp (__match_any_sync), not one
    # per slot.
    "warp_aggregated": [("sort_pass<false, kSortUnroll, false>", "sort_pass<false, kSortUnroll, true>"),
                        ("sort_pass<true, kPlaceUnroll, false>", "sort_pass<true, kPlaceUnroll, true>")],
    "sort_1024": [("constexpr int kSortSlots = 2048;", "constexpr int kSortSlots = 1024;")],
    "sort_4096": [("constexpr int kSortSlots = 2048;", "constexpr int kSortSlots = 4096;")],
    "sorted_ctas_3": [("constexpr int kMinCtasPerSm = 4;", "constexpr int kMinCtasPerSm = 3;")],
    "sorted_ctas_6": [("constexpr int kMinCtasPerSm = 4;", "constexpr int kMinCtasPerSm = 6;")],
    "place_unroll_8": [("constexpr int kPlaceUnroll = 4;", "constexpr int kPlaceUnroll = 8;")],
    "groups_2": [("if (a.nquads <= 4) return launch<N_IN, 4, 1>(a, device, stream);",
                  "if (a.nquads <= 4) return launch<N_IN, 2, 2>(a, device, stream);")],
    # The groups' first and last runs never joined or added.
    "no_edges": [("      keep_warp_runs<G, NQ>(a, g, runs, out_row0, s_runs, s_run_row);\n",
                  "      if (runs.f == -7) s_run_row[0] = runs.l;\n"),
                 ("      pending = out_row0;\n", "")],
    # Thread 0 of each CTA reads the SM clock after each of a chunk's
    # barriers and adds the cycles between to its phase's total (PHASES).
    "phase_clocks": [
        ("namespace {\n\nconstexpr int kMaxIn = 4;",
         "namespace {\n\n__device__ unsigned long long g_phase_cycles[4];\n"
         "#define PHASE(i) { const long long t = clock64(); ph[i] += t - tk; tk = t; }\n\n"
         "constexpr int kMaxIn = 4;"),
        ("  int64_t b = b_begin;\n  while (b < b_end) {",
         "  unsigned long long ph[4] = {};\n  long long tk = clock64();\n"
         "  int64_t b = b_begin;\n  while (b < b_end) {"),
        ("      __syncthreads();  // row counts complete; the last chunk's runs are added\n",
         "      __syncthreads();  // row counts complete; the last chunk's runs are added\n      PHASE(0)\n"),
        ("      const int total = exclusive_scan(s_count, rows_here, s_warp);\n",
         "      const int total = exclusive_scan(s_count, rows_here, s_warp);\n      PHASE(1)\n"),
        ("      __syncthreads();  // the sorted fields are complete\n",
         "      __syncthreads();  // the sorted fields are complete\n      PHASE(2)\n"),
        ("      __syncthreads();  // the chunk's rows are done; the fields are free; the warps' runs are kept\n",
         "      __syncthreads();  // the chunk's rows are done; the fields are free; the warps' runs are kept\n"
         "      PHASE(3)\n"),
        ("    b = e;\n  }\n  if (threadIdx.x < 32) {",
         "    b = e;\n  }\n  if (threadIdx.x == 0) {\n    for (int i = 0; i < 4; ++i) "
         "atomicAdd(&g_phase_cycles[i], ph[i]);\n  }\n  if (threadIdx.x < 32) {"),
        ("}  // namespace\n\n// Launch on",
         "}  // namespace\n\nextern \"C\" int mttkrp_probe_phase_cycles(unsigned long long* host) {\n"
         "  cudaError_t err = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles));\n"
         "  const unsigned long long zero[4] = {};\n"
         "  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));\n"
         "  return static_cast<int>(err);\n}\n\n// Launch on")],
}


def layout_of(text: str) -> str | None:
    """The first layout whose cut anchors the source all holds, else None
    (the source is then timed whole and in its matching edits only)."""
    for layout, cuts in CUTS.items():
        if all(a in text and b in text for a, b in cuts.values()):
            return layout
    return None


def cut(text: str, layout: str, phases) -> str:
    for ph in phases:
        start, end = CUTS[layout][ph]
        i = text.index(start)
        text = text[:i] + text[text.index(end, i):]
    return text


def variant_libs(label: str, src: Path) -> dict[str, ctypes.CDLL]:
    """Build the whole source and its cut and edited copies in parallel,
    each in `build/probe/<label>/<variant>/` beside copies of the headers in
    the source's directory (the checkout's csrc/ headers where it has none);
    an edit applies to the source and the headers alike.  Returns
    {variant: library}."""
    headers = sorted(src.parent.glob("*.cuh")) or sorted(build.CSRC_DIR.glob("*.cuh"))
    files = {"mttkrp.cu": src.read_text(), **{h.name: h.read_text() for h in headers}}
    layout = layout_of(files["mttkrp.cu"])
    variants = {name: {**files, "mttkrp.cu": cut(files["mttkrp.cu"], layout, phases)}
                for name, phases in VARIANTS.get(layout, {"whole": ()}).items()}
    for name, reps in EDITS.items():
        if all(any(old in text for text in files.values()) for old, _ in reps):
            var = dict(files)
            for old, new in reps:
                var = {f: text.replace(old, new) for f, text in var.items()}
            variants[name] = var
    libs, procs = {}, []
    for name, var in variants.items():
        out_dir = PROBE_DIR / label / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for f, text in var.items():
            (out_dir / f).write_text(text)
        lib = out_dir / "mttkrp.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(out_dir / "mttkrp.cu")]
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
    out = {}
    if "compact" in t and "no_flush" in t:
        flush = t["whole"] - t["no_flush"]
        out.update(compact_ms=t["compact"], gathers_ms=t["no_tile_atomics"] - t["compact"],
                   tile_atomics_ms=t["whole"] - t["no_tile_atomics"] - flush, flush_ms=flush,
                   factor_loads_ms=t["whole"] - t["no_loads"])
    if "sort" in t and "rows_no_flush" in t:
        flush = t["whole"] - t["rows_no_flush"]
        out.update(sort_ms=t["sort"], count_scan_ms=t["count"], place_ms=t["sort"] - t["count"],
                   rows_ms=t["whole"] - t["sort"] - flush, flush_ms=flush,
                   factor_loads_ms=t["whole"] - t["rows_no_loads"])
    if "no_edges" in t:
        out["edges_ms"] = t["whole"] - t["no_edges"]
    out.update({f"{k}_ms": t[k] for k in ("ranges_64", "ctas_6", "ctas_8", "sort_1024", "sort_4096",
                                          "sorted_ctas_3", "sorted_ctas_6", "place_unroll_8",
                                          "groups_2", "warp_aggregated") if k in t})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a mttkrp.cu to split (repeatable); default: the checkout's")
    ap.add_argument("--out", default=str(PROBE_DIR / "mttkrp_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mttkrp_probe: needs a CUDA device", file=sys.stderr)
        return 1
    sources = [s.split("=", 1) for s in args.source] or [["current", str(build.CSRC_DIR / "mttkrp.cu")]]
    recs: list = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"probe": "device", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}, recs)

    t0 = time.perf_counter()
    built = {label: variant_libs(label, Path(path)) for label, path in sources}
    emit({"probe": "build", "s": time.perf_counter() - t0, "sources": dict(sources),
          "ptxas": {label: [ln.strip() for ln in (PROBE_DIR / label / "whole" / "mttkrp.log").read_text()
                            .splitlines() if "registers" in ln or "spill" in ln]
                    for label, _ in sources}}, recs)

    st = synthetic_tensor(NELL2_SHAPE, NELL2_NNZ, seed=0, skew=NELL2_SKEW)
    ws = make_planned_cp_als(st, RANK, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    real_load = build.load
    for m in range(st.nmodes):
        plan = ws.plan_for(m)
        facs = [torch.randn((rows, rank_padded(RANK)), generator=gen, device="cuda") for rows in plan.in_rows]
        exact = mttkrp_blocked_plain(dataclasses.replace(plan, vals=plan.vals.double()),
                                     [f.double() for f in facs])
        scale = exact.abs().amax(0).clamp_min(1e-300)
        for label, libs in built.items():
            times: dict[str, list[float]] = {}
            # In turns: whole, the other variants, whole again (the spread).
            for name in ["whole", *(k for k in libs if k != "whole"), "whole"]:
                with_library(libs[name])
                times.setdefault(name, []).append(cuda_ms(lambda: mttkrp_blocked(plan, facs)))
            clocks = {}
            if "phase_clocks" in libs:  # one launch's CTA cycles per phase
                lib, cycles = libs["phase_clocks"], (ctypes.c_ulonglong * len(PHASES))()
                with_library(lib)
                lib.mttkrp_probe_phase_cycles(cycles)  # zeroes the totals
                mttkrp_blocked(plan, facs)
                torch.cuda.synchronize()
                if lib.mttkrp_probe_phase_cycles(cycles) != 0:
                    raise RuntimeError("reading the phase clocks failed")
                total = sum(cycles)
                clocks = {"phase_cycle_share": {ph: c / total for ph, c in zip(PHASES, cycles)}}
            with_library(libs["whole"])
            got = mttkrp_blocked(plan, facs)
            err = float(((got.double() - exact).abs().amax(0) / scale).max())
            build.load = real_load
            t = {k: min(v) for k, v in times.items()}
            emit({"probe": "split", "source": label, "mode": m, "ms": times, **phases(t), **clocks,
                  "whole_max_rel_err": err}, recs)
            del got
        del facs, exact

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
