"""The port's planned sweeps in two or more checkouts, timed in turns on one
NVIDIA GPU.

    python3 scripts/torch_sweep_probe.py --tree before=PATH --tree after=PATH [--rounds 2] [--out FILE]

Each PATH is the root of a checkout of this repository (`src/repro_torch/`
under it).  First every checkout's kernels are built, one process per
checkout, all at once (`repro_torch.kernels.build.build_all`, into that
checkout's own `build/kernels/`).  Then each round runs every checkout in
turn, in its own process, the order reversed from one round to the next
(A, B, then B, A, ...): the NELL-2-size synthetic tensor of chip_smoke.py
(12,092 x 9,184 x 28,818, 76,879,419 non-zeros, seed 0, skew 1.1), one
workspace per format (CP rank 16, Tucker (16, 16, 16), TT (16, 16)), one
warm-up sweep, then the mean ms of `--reps` sweeps by CUDA events, as
chip_smoke.py's phases c, e and g time them.  Prints one JSON line per
(round, checkout) and a last line with each checkout's per-format times
over the rounds, and writes them all to --out (default
`build/probe/sweep_probe.json`).  Needs a CUDA device and nvcc; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE, NNZ, SKEW = (12_092, 9_184, 28_818), 76_879_419, 1.1
RANK, CORE_RANKS, TT_RANKS = 16, (16, 16, 16), (16, 16)


def child(reps: int) -> None:
    """Time the three sweeps with the `repro_torch` on sys.path."""
    import torch

    from repro_torch.core.coo import synthetic_tensor
    from repro_torch.kernels.ops import make_planned_cp_als
    from repro_torch.tt.als import core_to_matrix, init_tt_cores, make_planned_tt
    from repro_torch.tucker.hooi import init_tucker_factors, make_planned_tucker
    import repro_torch

    def cuda_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    torch.backends.cuda.matmul.allow_tf32 = False
    st = synthetic_tensor(SHAPE, NNZ, seed=0, skew=SKEW)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.from_numpy(st.indices).to(dev)
    val = torch.from_numpy(st.values).to(dev)
    norm_x_sq = torch.tensor(float((st.values.astype("float64") ** 2).sum()), device=dev)
    out = {"package": str(Path(repro_torch.__file__).parent), "device": torch.cuda.get_device_name(0)}

    ws = make_planned_cp_als(st, RANK, device=dev)
    facs = ws.pad_factors([torch.randn((s, RANK), generator=gen, device=dev) / math.sqrt(RANK)
                           for s in st.shape])
    facs, _, _ = ws.sweep(facs, idx, val, norm_x_sq, first=True)
    out["cp_ms"] = cuda_ms(lambda: ws.sweep(facs, idx, val, norm_x_sq))
    del ws, facs

    ws = make_planned_tucker(st, CORE_RANKS, device=dev)
    facs = ws.pad_factors(init_tucker_factors(st.shape, CORE_RANKS, seed=0, device=dev))
    facs, _, _ = ws.sweep(facs, norm_x_sq)
    out["tucker_ms"] = cuda_ms(lambda: ws.sweep(facs, norm_x_sq))
    del ws, facs

    ws = make_planned_tt(st, TT_RANKS, device=dev)
    facs = ws.pad_factors([core_to_matrix(c) for c in init_tt_cores(st.shape, TT_RANKS, seed=0, device=dev)])
    facs, _, _ = ws.sweep(facs, idx, val, norm_x_sq)
    out["tt_ms"] = cuda_ms(lambda: ws.sweep(facs, idx, val, norm_x_sq))
    print(json.dumps(out), flush=True)


def run(tree: Path, args: list[str], timeout: int) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    return subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "build" / "probe" / "sweep_probe.json"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.reps)
        return 0
    if len(a.tree) < 2:
        ap.error("give two or more --tree LABEL=PATH")
    trees = {}
    for t in a.tree:
        label, _, path = t.partition("=")
        trees[label] = Path(path).resolve()
    builds = {label: subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import build; build.build_all()"],
        env=dict(os.environ, PYTHONPATH=str(tree / "src")), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for label, tree in trees.items()}
    for label, proc in builds.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            print(f"build of {label} failed:\n{log}", file=sys.stderr)
            return 1
    records = []
    order = list(trees)
    for r in range(a.rounds):
        for label in order:
            res = run(trees[label], [__file__, "--child", "--reps", str(a.reps)], 900)
            if res.returncode != 0:
                print(f"{label}, round {r}, failed:\n{res.stdout}\n{res.stderr}", file=sys.stderr)
                return 1
            rec = {"round": r, "tree": label, **json.loads(res.stdout.strip().splitlines()[-1])}
            records.append(rec)
            print(json.dumps(rec), flush=True)
        order.reverse()
    summary = {label: {fmt: [x[f"{fmt}_ms"] for x in records if x["tree"] == label]
                       for fmt in ("cp", "tucker", "tt")} for label in trees}
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps({"records": records, "summary": summary}, indent=1) + "\n")
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
