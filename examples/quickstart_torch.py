"""Quickstart for the PyTorch port: CP-ALS on the planned MTTKRP kernel,
Tucker HOOI on the planned TTMc kernel, or TT-ALS on the planned TT-core
kernel.

The torch counterpart of `examples/quickstart.py`.
`repro_torch.api.decompose(st, rank, format=...)` builds one BlockPlan per
output mode on the device (the Tensor Remapper), then runs every iteration
through the hand-written CUDA kernel of its format.

  PYTHONPATH=src python examples/quickstart_torch.py                  # GPU: nell2_like, CP rank 16
  PYTHONPATH=src python examples/quickstart_torch.py --algo tucker    # GPU: Tucker, core ranks 16
  PYTHONPATH=src python examples/quickstart_torch.py --algo tt        # GPU: TT-ALS, TT ranks 16
  PYTHONPATH=src python examples/quickstart_torch.py --fast --devices 2 --algo tt
  PYTHONPATH=src python examples/quickstart_torch.py --fast --auto-tune cached
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --algo tucker --rank 3,5,2
  PYTHONPATH=src python examples/quickstart_torch.py --trace cp.jsonl

On the CPU (the tiny preset) the kernels' plain PyTorch versions run instead.

--fast         the smoke subset: the tiny preset and 2 iterations on any
               device.
--devices N    after the headline call, the sharded planned path
               (`method="pallas_sharded"`, repro_torch.dist.planned): each
               mode's stream split into N balanced output-tile ranges, one
               plan per shard on its device, the kernel launched once per
               shard and the partial outputs reduced.  The shards go on
               the first N cards where the machine has them, else all N on
               the one device in turn (`shard_plan(["cuda:0"] * N)`, the
               port's counterpart of the reference's forced host device
               count); the script says which, and exits 1 when the sharded
               fits leave the single-device ones by more than 1e-5.
--auto-tune    off | on | cached: `decompose(auto_tune=False | True |
               "cached")` for the headline call.  "on" searches the PMS's
               geometries per mode every run; "cached" keeps each mode's
               pick in the port's autotune cache ($REPRO_TORCH_AUTOTUNE_DIR,
               or ~/.cache/repro-torch-autotune), so a rerun evaluates no
               configuration.
--trace PATH   export the trace of the headline decompose() call as JSONL
               (repro_torch.obs.trace: the decompose, drive and sweep spans,
               each sweep carrying its PMS-predicted time); summarize it
               with `python scripts/torch_trace_report.py PATH --pms`.
               REPRO_TORCH_TRACE=1 (or =PATH) instead enables
               process-global tracing for everything this script runs.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

#: Largest gap between the sharded and the single-device fits.
SHARD_FIT_TOL = 1e-5
AUTO_TUNE = {"off": False, "on": True, "cached": "cached"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises when no GPU is present)")
    ap.add_argument("--algo", default="cp", choices=("cp", "tucker", "tt"))
    ap.add_argument("--rank", default="16",
                    help="CP rank; Tucker core ranks (one int for every mode or a comma list); "
                         "or TT ranks (one int for every bond or a comma list of N-1)")
    ap.add_argument("--iters", type=int, default=None, help="iterations (default 5; 2 with --fast)")
    ap.add_argument("--fast", action="store_true", help="smoke subset: the tiny preset, 2 iterations")
    ap.add_argument("--devices", type=int, default=1,
                    help="then run the sharded planned path over N shards")
    ap.add_argument("--auto-tune", choices=tuple(AUTO_TUNE), default="off", dest="auto_tune",
                    help="PMS tuning of the headline decompose() call")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export the headline decompose() call's trace as JSONL to PATH")
    return ap.parse_args(argv)


def _ranks(algo: str, rank: str, nmodes: int):
    ranks = [int(r) for r in rank.split(",")]
    if algo == "cp":
        if len(ranks) != 1:
            raise SystemExit(f"--algo cp takes one rank, got {rank}")
        return ranks[0]
    n = nmodes if algo == "tucker" else nmodes - 1
    return tuple(ranks) if len(ranks) > 1 else (ranks[0],) * n


def _shards(n: int, device: torch.device):
    """(ShardingPlan, what it is): the first n cards where there are as
    many, else n shards on `device` in turn."""
    from repro_torch.dist.planned import shard_plan

    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return shard_plan(n), f"{n} shards on {n} cards"
    return shard_plan([device] * n), f"{n} shards in turn on {device}"


def _counter_sum(prefix: str) -> float:
    from repro_torch.obs import metrics

    return sum(v for k, v in metrics.snapshot()["counters"].items() if k.startswith(prefix))


def main(argv=None, out: dict | None = None) -> int:
    """Run the quickstart; `out`, where given, receives "fit_history", the
    headline call's "configs_evaluated" and "autotune_cache_hits", the
    "launches" of its kernel, and with --devices N > 1 "sharded_fit_history"
    and "shards" (what ran where)."""
    a = parse_args(argv)
    from repro_torch.api import decompose
    from repro_torch.core.coo import frostt_like
    from repro_torch.device import resolve_device
    from repro_torch.kernels.mttkrp import mttkrp_blocked
    from repro_torch.kernels.ops import make_planned_cp_als
    from repro_torch.kernels.tt import ttcore_blocked
    from repro_torch.kernels.ttm import ttmc_blocked
    from repro_torch.tt import make_planned_tt
    from repro_torch.tucker import make_planned_tucker

    device = resolve_device(a.device)
    preset = "tiny" if a.fast or device.type == "cpu" else "nell2_like"
    iters = a.iters if a.iters is not None else (2 if a.fast else 5)
    auto_tune = AUTO_TUNE[a.auto_tune]
    st = frostt_like(preset)
    print(f"tensor {preset}: shape={st.shape} nnz={st.nnz:,} density={st.density:.2e} "
          f"algo={a.algo} devices={a.devices} auto_tune={a.auto_tune}")
    r = _ranks(a.algo, a.rank, st.nmodes)
    build, kernel = {"cp": (make_planned_cp_als, mttkrp_blocked), "tucker": (make_planned_tucker, ttmc_blocked),
                     "tt": (make_planned_tt, ttcore_blocked)}[a.algo]

    ws = None
    if not auto_tune:  # with --auto-tune the facade builds (or loads) each mode's pick itself
        t0 = time.perf_counter()
        ws = build(st, r, device=device)
        for m in range(st.nmodes):
            p = ws.plan_for(m)
            print(f"mode {m}: {p.nblocks:,} blocks of {p.blk}, padding {p.padding_fraction():.1%}, "
                  f"{p.output_tile_runs()} output-tile runs")
        print(f"plans built on {ws.device} in {time.perf_counter() - t0:.2f}s")

    evaluated, hits, launches = (_counter_sum("pms.configs_evaluated"), _counter_sum("autotune_cache.hits"),
                                 kernel.launches)
    t0 = time.perf_counter()
    state = decompose(st, r, format=a.algo, iters=iters, seed=0, planned=ws, auto_tune=auto_tune, device=device,
                      verbose=True, trace=a.trace)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = kernel.launches - launches
    print(f"{a.algo} fit={state.fit_history[-1]:.4f} in {time.perf_counter() - t0:.2f}s "
          f"({launches} CUDA kernel launches)")
    evaluated = _counter_sum("pms.configs_evaluated") - evaluated
    hits = _counter_sum("autotune_cache.hits") - hits
    if auto_tune:
        print(f"auto-tune {a.auto_tune}: {evaluated:.0f} configurations evaluated, {hits:.0f} autotune cache hits")
    fits = list(state.fit_history)
    if out is not None:
        out.update(fit_history=fits, configs_evaluated=evaluated, autotune_cache_hits=hits, launches=launches)
    del ws, state

    rc = 0
    if a.devices > 1:
        dist, where = _shards(a.devices, device)
        print(f"sharded: {where}")
        t0 = time.perf_counter()
        sh = decompose(st, r, format=a.algo, iters=iters, seed=0, method="pallas_sharded", dist=dist,
                       verbose=True)
        gap = max(abs(x - y) for x, y in zip(sh.fit_history, fits))
        print(f"{a.algo} (sharded x{a.devices}) fit={sh.fit_history[-1]:.4f} in {time.perf_counter() - t0:.2f}s "
              f"(single-device fit {fits[-1]:.4f}, largest gap {gap:.2e}; must be within {SHARD_FIT_TOL:g})")
        if out is not None:
            out.update(sharded_fit_history=list(sh.fit_history), shards=where)
        rc = 0 if gap <= SHARD_FIT_TOL else 1
    if a.trace:
        from repro_torch.obs.calibrate import format_table, join_trace

        print(f"trace -> {a.trace} (summarize: python scripts/torch_trace_report.py {a.trace} --pms)")
        print(format_table(join_trace(a.trace)))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
