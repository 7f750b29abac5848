"""The PMS's predictions against the kernels' times over a wide sample of
plan geometries, at NELL-2 size, on one NVIDIA GPU.

    python3 scripts/torch_pms_probe.py [--out FILE] [--reps 5] [--random 6]

For each kernel and mode that `chip_smoke.py` phase i times (MTTKRP modes
0, 1 and 2 at rank 16, TTMc mode 0 at core ranks (16, 16, 16), TT-core
modes 0 and 1 at TT ranks (16, 16)), on the NELL-2-size synthetic tensor
(12,092 x 9,184 x 28,818, 76,879,419 non-zeros, seed 0, skew 1.1), it
builds the plan of each configuration in a sample and times the kernel on
it (the least of two runs of `--reps` launches, CUDA events, after a
warm-up).  The sample: tile_i x blk over {128, 256, 512, 1024}^2 at input
tiles 256; seven input-tile pairs at tile_i 256, blk 256; every tile at
1,024 (blk 256 and 1,024); the PMS's top 3 and its last 2 feasible
configurations; and `--random` more drawn from the feasible grid (seed 0);
less those whose layout the occupancy model puts past MAX_SLOTS slots.
The default configuration is timed first, again halfway and last, as a
measure of drift.

Beside each time it records everything the PMS reads of the layout (the
plan's blocks, fills, padding, real non-zeros, tiles), the kernel's launch
at the configuration (shared memory, row parts, column slices, occupancy,
step share), the PMS's estimate and its terms, and counts the kernels'
work depends on: the distinct (64-block range, output row) pairs and
(2,048-slot chunk, output row) pairs among the real slots, and per input
mode the distinct (range, input row) pairs.  Prints one JSON line per
(kernel, mode) and writes all of them to --out (default
`build/probe/pms_probe.json`).  Needs a CUDA device and nvcc; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core import pms  # noqa: E402
from repro_torch.core.coo import synthetic_tensor  # noqa: E402
from repro_torch.core.hypergraph import stats as hg_stats  # noqa: E402
from repro_torch.core.memctrl import (  # noqa: E402
    CacheEngineConfig,
    DMAEngineConfig,
    GPUSpec,
    MemoryControllerConfig,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mttkrp import mttkrp_blocked, rank_padded  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    make_planned_mttkrp,
    make_planned_ttcore,
    make_planned_ttmc,
)
from repro_torch.kernels.tt import ttcore_blocked  # noqa: E402
from repro_torch.kernels.ttm import ttmc_blocked  # noqa: E402

SHAPE, NNZ, SKEW = (12_092, 9_184, 28_818), 76_879_419, 1.1
RANK, CORE_RANKS, TT_RANKS = 16, (16, 16, 16), (16, 16)
MODES = {"mttkrp": (0, 1, 2), "ttmc": (0,), "tt": (0, 1)}
TILES = (128, 256, 512, 1024)
RANGE_BLOCKS = 64  # blocked.cuh kBlocksPerCta
CHUNK_SLOTS = 2048  # the MTTKRP kernel's sorted chunk
# Configurations whose layout the occupancy model puts past this many slots
# (small tiles at large blocks: mostly padding) are left out of the sample:
# their plan builds would not fit the card beside their temporaries.
MAX_SLOTS = 500_000_000


def cfg_of(ti: int, tj: int, tk: int, blk: int) -> MemoryControllerConfig:
    return MemoryControllerConfig(cache=CacheEngineConfig(tile_i=ti, tile_j=tj, tile_k=tk),
                                  dma=DMAEngineConfig(blk=blk))


def label(cfg: MemoryControllerConfig) -> list[int]:
    c = cfg.cache
    return [c.tile_i, c.tile_j, c.tile_k, cfg.dma.blk]


def model_of(kernel: str, nmodes: int, mode: int):
    ranks = {"mttkrp": None, "ttmc": CORE_RANKS, "tt": TT_RANKS}[kernel]
    return pms._kernel_model(kernel, RANK, ranks, nmodes, mode), ranks


def sample(kernel: str, hs, mode: int, n_random: int) -> list[MemoryControllerConfig]:
    model, ranks = model_of(kernel, hs.nmodes, mode)
    spec = GPUSpec()
    feasible = list(pms._feasible_configs(model, spec, TILES, TILES))
    scored = sorted(feasible, key=lambda c: pms._analytic(model, hs, mode, c, spec).t_total)
    want = [cfg_of(ti, 256, 256, blk) for ti in TILES for blk in TILES]
    want += [cfg_of(256, tj, tk, 256) for tj, tk in
             ((128, 128), (512, 512), (1024, 1024), (128, 1024), (1024, 128), (512, 128), (128, 512))]
    want += [cfg_of(1024, 1024, 1024, 256), cfg_of(1024, 1024, 1024, 1024)]
    want += scored[:3] + scored[-2:]
    want += random.Random(0).sample(feasible, min(n_random, len(feasible)))
    out = []
    for c in want:
        nblocks = pms._analytic_layout(hs, mode, c)[0]
        if c in feasible and c not in out and nblocks * c.dma.blk <= MAX_SLOTS:
            out.append(c)
    return out


def distinct(keys: torch.Tensor) -> int:
    return int(torch.unique(keys).numel())


def layout_counts(plan, step_ranges: int = 256) -> dict:
    """Counts of the kernels' work on a plan's real slots, taken in steps
    of `step_ranges` 64-block ranges (a step holds whole ranges and whole
    2,048-slot chunks, so the distinct pairs add up across steps)."""
    counts = {"range_out_rows": 0, "chunk_out_rows": 0, "range_in_rows": [0] * plan.n_in}
    step = step_ranges * RANGE_BLOCKS
    for b0 in range(0, plan.nblocks, step):
        b1 = min(plan.nblocks, b0 + step)
        s0, s1 = b0 * plan.blk, b1 * plan.blk
        real = plan.vals[s0:s1] != 0
        pos = torch.arange(s0, s1, device=plan.device, dtype=torch.int64)
        blk_of = pos // plan.blk
        rng = blk_of // RANGE_BLOCKS
        row = plan.block_it[b0:b1].long().repeat_interleave(plan.blk) * plan.tile_i + plan.iloc[s0:s1].long()
        counts["range_out_rows"] += distinct((rng * plan.out_rows + row)[real])
        counts["chunk_out_rows"] += distinct(((pos // CHUNK_SLOTS) * plan.out_rows + row)[real])
        for n in range(plan.n_in):
            r = (plan.block_in[n][b0:b1].long().repeat_interleave(plan.blk) * plan.in_tiles[n]
                 + plan.in_locs[n][s0:s1].long())
            counts["range_in_rows"][n] += distinct((rng * plan.in_rows[n] + r)[real])
        del real, pos, blk_of, rng, row
    counts["ranges"] = -(-plan.nblocks // RANGE_BLOCKS)
    return counts


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def measure(kernel: str, st, mode: int, cfg, reps: int, gen) -> dict:
    spec = GPUSpec()
    ranks = {"mttkrp": None, "ttmc": CORE_RANKS, "tt": TT_RANKS}[kernel]
    if kernel == "mttkrp":
        op = make_planned_mttkrp(st, mode, RANK, cfg=cfg, device="cuda")
        widths = [rank_padded(RANK)] * op.plan.n_in
        run = lambda p, f: mttkrp_blocked(p, f)  # noqa: E731
        est = pms.predict_from_plan(op.plan, RANK, cfg, spec)
    elif kernel == "ttmc":
        op = make_planned_ttmc(st, mode, ranks, cfg=cfg, device="cuda")
        widths = [rank_padded(r) for r in op.in_ranks]
        run = lambda p, f: ttmc_blocked(p, f, op.in_ranks)  # noqa: E731
        est = pms.predict_ttmc(op.plan, ranks, cfg, spec)
    else:
        op = make_planned_ttcore(st, mode, ranks, cfg=cfg, device="cuda")
        widths = [rank_padded(a * b) for a, b in op.in_rank_pairs]
        run = lambda p, f: ttcore_blocked(p, f, op.in_rank_pairs, op.n_left)  # noqa: E731
        est = pms.predict_tt(op.plan, ranks, cfg, spec)
    plan = op.plan
    facs = [torch.randn((rows, w), generator=gen, device="cuda") for rows, w in zip(plan.in_rows, widths)]
    ms = cuda_ms(lambda: run(plan, facs), reps)
    row = {"cfg": label(cfg), "ms": ms, "nblocks": plan.nblocks, "blk": plan.blk, "nnz": plan.nnz,
           "tile_i": plan.tile_i, "in_tiles": list(plan.in_tiles), "out_rows": plan.out_rows,
           "in_rows": list(plan.in_rows), "fills": plan.tile_fills(),
           "padding": plan.padding_fraction(), "output_tile_runs": plan.output_tile_runs(),
           **layout_counts(plan),
           "est": {k: v for k, v in dataclasses.asdict(est).items() if k != "cfg"},
           "predicted_ms": est.t_total * 1e3}
    del op, plan, facs
    torch.cuda.empty_cache()
    print(json.dumps({"kernel": kernel, "mode": mode, "cfg": row["cfg"], "slots": row["nblocks"] * row["blk"],
                      "ms": ms, "allocated": torch.cuda.memory_allocated()}), file=sys.stderr, flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe" / "pms_probe.json"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--random", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pms_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    st = synthetic_tensor(SHAPE, NNZ, seed=0, skew=SKEW)
    hs = hg_stats(st)
    gen = torch.Generator(device="cuda").manual_seed(0)
    default = MemoryControllerConfig()
    results = []
    for kernel, modes in MODES.items():
        for m in modes:
            t0 = time.perf_counter()
            cfgs = sample(kernel, hs, m, args.random)
            drift = [measure(kernel, st, m, default, args.reps, gen)["ms"]]
            rows = []
            for k, cfg in enumerate(cfgs):
                rows.append(measure(kernel, st, m, cfg, args.reps, gen))
                if k == len(cfgs) // 2:
                    drift.append(measure(kernel, st, m, default, args.reps, gen)["ms"])
            drift.append(measure(kernel, st, m, default, args.reps, gen)["ms"])
            res = {"kernel": kernel, "mode": m, "default_ms_drift": drift, "configs": rows,
                   "seconds": time.perf_counter() - t0}
            print(json.dumps({"kernel": kernel, "mode": m, "n": len(rows), "drift": drift,
                              "seconds": res["seconds"],
                              "ms": [round(r["ms"], 3) for r in rows],
                              "predicted_ms": [round(r["predicted_ms"], 3) for r in rows]}), flush=True)
            results.append(res)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                               "build_s": build_s, "results": results}))
    print(json.dumps({"out": str(out), "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
