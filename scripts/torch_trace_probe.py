"""How the CP and Tucker sweeps' times move from one drive to the next, with
tracing on and off, at NELL-2 size on one NVIDIA GPU.

    python3 scripts/torch_trace_probe.py [--drives N] [--iters K] [--out FILE]

On the tensor of chip_smoke.py phases d and f (12,092 x 9,184 x 28,818,
76,879,419 non-zeros, `synthetic_tensor(seed=0, skew=1.1)`), CP at rank 16
and Tucker at core ranks (16, 16, 16), one planned workspace per format:

  * "b2b": back-to-back sweeps timed by CUDA events, as phases d and f time
    them (3 sweeps per measurement, 8 measurements);
  * N drives (default 24) of `decompose(..., planned=ws, iters=K)` in turns
    of three kinds: untraced ("off"), traced ("on"), and traced with the
    spans' `torch.profiler.record_function` replaced by a no-op ("norf");
    each drive's steady sweeps (all but the first) from `drive.iter_seconds`
    and, when traced, its sweep spans;
  * for Tucker, `torch.linalg.eigh` of a (256, 256) Gram alone, 60 calls
    each timed by the host clock between synchronizations.

Prints one JSON line per format (every sample, each kind's median and each
drive's median) and writes them to --out (default
`build/probe/trace_probe.json`).  Needs a CUDA device and nvcc (the kernels
are built on first use); imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPE = (12_092, 9_184, 28_818)
NNZ = 76_879_419
SKEW = 1.1
RANK = 16
CORE_RANKS = (16, 16, 16)
KINDS = ("off", "on", "norf", "norf", "on", "off")
B2B_REPS = 3
B2B_MEASURES = 8
EIGH_CALLS = 60


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--drives", type=int, default=24)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--out", default=str(ROOT / "build" / "probe" / "trace_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_trace_probe: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.api import decompose
    from repro_torch.core.coo import synthetic_tensor
    from repro_torch.kernels.ops import make_planned_cp_als
    from repro_torch.obs import metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.tucker.hooi import init_tucker_factors, make_planned_tucker

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    st = synthetic_tensor(SHAPE, NNZ, seed=0, skew=SKEW)
    idx = torch.from_numpy(st.indices).to(dev)
    val = torch.from_numpy(st.values).to(dev)
    norm_x_sq = torch.tensor(float((st.values.astype("float64") ** 2).sum()), device=dev)

    def cuda_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(B2B_REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / B2B_REPS

    real_rf = torch.profiler.record_function
    results = []
    formats = {
        "cp": (RANK, "cp_als", lambda: make_planned_cp_als(st, RANK, device=dev)),
        "tucker": (CORE_RANKS, "tucker_hooi", lambda: make_planned_tucker(st, CORE_RANKS, device=dev)),
    }
    for fmt, (rank, label, build_ws) in formats.items():
        ws = build_ws()
        out = {"format": fmt, "device": torch.cuda.get_device_name(0), "iters": args.iters}
        if fmt == "cp":
            gen = torch.Generator(device=dev).manual_seed(0)
            facs = ws.pad_factors([torch.randn((s, RANK), generator=gen, device=dev) / RANK ** 0.5
                                   for s in st.shape])
            facs, _, _ = ws.sweep(facs, idx, val, norm_x_sq, first=True)
            sweep = lambda: ws.sweep(facs, idx, val, norm_x_sq)  # noqa: E731
        else:
            facs = ws.pad_factors(init_tucker_factors(st.shape, rank, seed=0, device=dev))
            facs, _, _ = ws.sweep(facs, norm_x_sq)
            sweep = lambda: ws.sweep(facs, norm_x_sq)  # noqa: E731
        out["b2b_ms"] = [cuda_ms(sweep) for _ in range(B2B_MEASURES)]
        del facs, sweep

        drives = {k: [] for k in dict.fromkeys(KINDS)}
        spans = {"on": [], "norf": []}
        for d in range(args.drives):
            kind = KINDS[d % len(KINDS)]
            metrics.reset()
            tracer = obs_trace.Tracer() if kind != "off" else None
            if kind == "norf":
                torch.profiler.record_function = lambda name: contextlib.nullcontext()
            try:
                decompose(st, rank, format=fmt, iters=args.iters, seed=0, planned=ws, device=dev,
                          trace=tracer)
            finally:
                torch.profiler.record_function = real_rf
            drives[kind].append([x * 1e3 for x in
                                 metrics.histogram("drive.iter_seconds", label=label).sample[1:]])
            if tracer is not None:
                spans[kind] += [r["dur"] / 1e3 for r in tracer.records if r["name"] == "sweep"][1:]
        out["drives_ms"] = drives
        out["spans_ms"] = spans
        out["median_ms"] = {k: statistics.median(x for dr in v for x in dr) for k, v in drives.items()}
        out["drive_medians_ms"] = {k: [statistics.median(dr) for dr in v] for k, v in drives.items()}
        out["span_median_ms"] = {k: statistics.median(v) for k, v in spans.items()}
        out["b2b_median_ms"] = statistics.median(out["b2b_ms"])
        if fmt == "tucker":
            g = torch.randn((SHAPE[2], 256), device=dev)
            gram = g.T @ g
            eig = []
            for _ in range(EIGH_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.linalg.eigh(gram)
                torch.cuda.synchronize()
                eig.append((time.perf_counter() - t0) * 1e3)
            out["eigh_ms"] = eig
            del g, gram
        print(json.dumps(out), flush=True)
        results.append(out)
        del ws
        torch.cuda.empty_cache()

    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
