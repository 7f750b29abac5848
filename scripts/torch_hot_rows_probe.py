"""How far the MTTKRP kernel's hot-row sums stray from float64, launch by
launch, on one NVIDIA GPU.

    python3 scripts/torch_hot_rows_probe.py [--source LABEL=PATH ...]
        [--launches N] [--out FILE]

On the zipf-3 hot-row tensor of `tests/test_torch_gpu.py` (2,000 x 300 x
400, 50,000 non-zeros, about 41,700 of them in the hottest row of every
mode), at CP ranks 16 and 256, in the default geometry and in small tiles
with 640-slot blocks, every mode: N launches (default 100) of each kernel
source, each launch's largest error relative to each output column's max
against the plain version evaluated in float64 on the same float32 inputs
(the bound of the card tests and of chip_smoke.py phase c is 1e-5).  Per
(source, rank, geometry, mode) it reports the largest, the 99th
percentile and the median over the launches.

Sources: the checkout's `csrc/mttkrp.cu` ("current"), the same with its
run sums' sub-chains of 8 slots ("chain_8") or never folded ("chain_off":
a group's whole part is one chain, as before the sub-chains), with ranges
of 64 blocks however few CTAs that makes ("ranges_64"), with each chunk's
last run added to the output rather than carried into the next chunk
("no_carry"), without the floor of 8 blocks on a range
("no_range_floor"), and each
`--source LABEL=PATH` (default: `scripts/probe_kernels/mttkrp_pr18.cu` as
"pr18"), each built in `build/probe/hot_rows/<label>/` beside copies of the
headers of its own directory (the checkout's `csrc/*.cuh` for the
checkout's variants).  For scale, per (rank, mode) the same measure of the
plain version in float32 (`index_add_`, float32 atomics on the card), and
of float32 products summed in float64 ("products_f32": the error no
summation order removes).

Prints one JSON line per measurement and writes them all to --out
(default `build/probe/mttkrp_hot_rows.json`).  Needs a CUDA device and
nvcc, as chip_smoke.py does; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core.coo import synthetic_tensor  # noqa: E402
from repro_torch.core.memctrl import (  # noqa: E402
    CacheEngineConfig,
    DMAEngineConfig,
    MemoryControllerConfig,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mttkrp import _rows, mttkrp_blocked, mttkrp_blocked_plain, rank_padded  # noqa: E402
from repro_torch.kernels.ops import make_planned_cp_als  # noqa: E402

PROBE_DIR = ROOT / "build" / "probe" / "hot_rows"
SHAPE, NNZ, SKEW = (2_000, 300, 400), 50_000, 3.0
RANKS = (16, 256)
GEOMETRIES = {
    "default": MemoryControllerConfig(),
    "small_tiles_wide_blocks": MemoryControllerConfig(
        cache=CacheEngineConfig(tile_i=8, tile_j=16, tile_k=4), dma=DMAEngineConfig(blk=640)),
}
CHAIN = "constexpr int kChain = 32;"
RANGES = "long long ranges = static_cast<long long>(sms) * per_sm / a.slices;"
# The checkout's source (and headers) with edits: (old, new) pairs.
EDITS = {
    "current": [],
    "chain_8": [(CHAIN, "constexpr int kChain = 8;")],
    "chain_off": [(CHAIN, "constexpr int kChain = 1 << 30;")],
    # ranges of the most blocks a CTA takes (kBlocksPerCta), however few
    # CTAs that makes: fewer partial sums of a hot row reach the output
    "ranges_64": [(RANGES, "long long ranges = 1;")],
    # the carry flushed at every chunk (a hot row reaches the output once
    # per chunk), and no floor on a range's length (one wave of CTAs)
    "no_carry": [("if (carry == first) {", "if (false) {")],
    "no_range_floor": [("stream, kMinBlocksPerCta);", "stream, 1);")],
}


def emit(rec: dict, sink: list) -> None:
    sink.append(rec)
    print(json.dumps(rec), flush=True)


def build_all(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """Build every (label, source text, header directory) in parallel."""
    current = {"mttkrp.cu": (build.CSRC_DIR / "mttkrp.cu").read_text(),
               **{h.name: h.read_text() for h in build.CSRC_DIR.glob("*.cuh")}}
    jobs = {}
    for label, reps in EDITS.items():
        if all(any(old in text for text in current.values()) for old, _ in reps):
            var = dict(current)
            for old, new in reps:
                var = {f: text.replace(old, new) for f, text in var.items()}
            jobs[label] = var  # a checkout without an edit's anchor has no such variant
    for label, path in sources.items():
        jobs[label] = {"mttkrp.cu": path.read_text(),
                       **{h.name: h.read_text() for h in path.parent.glob("*.cuh")}}
    procs = []
    for label, files in jobs.items():
        out_dir = PROBE_DIR / label
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, text in files.items():
            (out_dir / name).write_text(text)
        lib = out_dir / "mttkrp.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(out_dir / "mttkrp.cu")]
        procs.append((label, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for label, lib, proc in procs:
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{out}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def rel_err(got: torch.Tensor, exact: torch.Tensor) -> float:
    """Largest error relative to each column's max of `exact`."""
    diff = (got.double() - exact).abs().amax(0)
    return float((diff / exact.abs().amax(0).clamp_min(1e-300)).max())


def products_f32(plan, facs) -> torch.Tensor:
    """The kernel's float32 products, summed into their rows in float64."""
    contrib = plan.vals[:, None]
    for f, tids, locs, tile in zip(facs, plan.block_in, plan.in_locs, plan.in_tiles):
        contrib = contrib * f.index_select(0, _rows(tids, locs, tile).flatten())
    rows = _rows(plan.block_it, plan.iloc, plan.tile_i).flatten()
    out = torch.zeros((plan.out_rows, contrib.shape[1]), dtype=torch.float64, device=contrib.device)
    return out.index_add_(0, rows, contrib.double())


def summary(errs: list[float]) -> dict:
    s = sorted(errs)
    return {"max": s[-1], "p99": s[int(0.99 * (len(s) - 1))], "median": s[len(s) // 2],
            "over_1e-5": sum(e > 1e-5 for e in s)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of an mttkrp.cu to measure beside the checkout's (repeatable)")
    ap.add_argument("--launches", type=int, default=100)
    ap.add_argument("--out", default=str(ROOT / "build" / "probe" / "mttkrp_hot_rows.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_hot_rows_probe: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    given = [s.split("=", 1) for s in args.source] or [
        ["pr18", str(ROOT / "scripts" / "probe_kernels" / "mttkrp_pr18.cu")]]
    libs = build_all({label: Path(path) for label, path in given})
    recs: list = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"nvidia_smi": smi, "shape": list(SHAPE), "nnz": NNZ, "skew": SKEW,
          "launches": args.launches, "sources": sorted(libs)}, recs)
    st = synthetic_tensor(SHAPE, NNZ, seed=0, skew=SKEW)
    gen = torch.Generator(device="cuda").manual_seed(0)
    real_load = build.load
    try:
        for rank in RANKS:
            for geometry, cfg in GEOMETRIES.items():
                ws = make_planned_cp_als(st, rank, cfg=cfg, device="cuda")
                for m in range(st.nmodes):
                    plan = ws.plan_for(m)
                    facs = [torch.randn((r, rank_padded(rank)), generator=gen, device="cuda")
                            for r in plan.in_rows]
                    exact = mttkrp_blocked_plain(dataclasses.replace(plan, vals=plan.vals.double()),
                                                 [f.double() for f in facs])
                    base = {"rank": rank, "geometry": geometry, "mode": m,
                            "max_row_nnz": int(st.mode_histogram(m).max())}
                    if geometry == "default":
                        emit({**base, "source": "plain_f32",
                              **summary([rel_err(mttkrp_blocked_plain(plan, facs), exact)
                                         for _ in range(5)])}, recs)
                        emit({**base, "source": "products_f32",
                              **summary([rel_err(products_f32(plan, facs), exact)])}, recs)
                    for label, lib in libs.items():
                        build.load = lambda name, lib=lib: lib
                        errs = [rel_err(mttkrp_blocked(plan, facs), exact) for _ in range(args.launches)]
                        emit({**base, "source": label, **summary(errs)}, recs)
                    build.load = real_load
                del ws
    finally:
        build.load = real_load
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
