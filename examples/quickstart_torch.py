"""Quickstart for the PyTorch port: CP-ALS on the planned MTTKRP kernel,
Tucker HOOI on the planned TTMc kernel, or TT-ALS on the planned TT-core
kernel.

The torch counterpart of `examples/quickstart.py --algo cp|tucker|tt`.
`repro_torch.api.decompose(st, rank, format=...)` builds one BlockPlan per
output mode on the device (the Tensor Remapper), then runs every iteration
through the hand-written CUDA kernel of its format.

  PYTHONPATH=src python examples/quickstart_torch.py                  # GPU: nell2_like, CP rank 16
  PYTHONPATH=src python examples/quickstart_torch.py --algo tucker    # GPU: Tucker, core ranks 16
  PYTHONPATH=src python examples/quickstart_torch.py --algo tt        # GPU: TT-ALS, TT ranks 16
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --algo tucker --rank 3,5,2
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --algo tt --rank 3,5
  PYTHONPATH=src python examples/quickstart_torch.py --trace cp.jsonl

On the CPU (the tiny preset) the kernels' plain PyTorch versions run instead.

--trace PATH exports the trace of the headline decompose() call as JSONL
(repro_torch.obs.trace: the decompose, drive and sweep spans, each sweep
carrying its PMS-predicted time; `repro_torch.obs.calibrate.join_trace(PATH)`
joins them into achieved_pct).  REPRO_TORCH_TRACE=1 (or =PATH) instead
enables process-global tracing for everything this script runs.
"""
import argparse
import time

import torch


def main(device: str | None, algo: str, rank: str, iters: int, trace: str | None = None) -> None:
    from repro_torch.api import decompose
    from repro_torch.core.coo import frostt_like
    from repro_torch.kernels.mttkrp import mttkrp_blocked
    from repro_torch.kernels.ops import make_planned_cp_als
    from repro_torch.kernels.tt import ttcore_blocked
    from repro_torch.kernels.ttm import ttmc_blocked
    from repro_torch.tt import make_planned_tt
    from repro_torch.tucker import make_planned_tucker

    preset = "tiny" if device == "cpu" else "nell2_like"
    st = frostt_like(preset)
    print(f"tensor {preset}: shape={st.shape} nnz={st.nnz:,} density={st.density:.2e}")

    ranks = [int(r) for r in rank.split(",")]
    if algo == "cp":
        if len(ranks) != 1:
            raise SystemExit(f"--algo cp takes one rank, got {rank}")
        r, build, kernel = ranks[0], make_planned_cp_als, mttkrp_blocked
    elif algo == "tucker":
        r = tuple(ranks) if len(ranks) > 1 else (ranks[0],) * st.nmodes
        build, kernel = make_planned_tucker, ttmc_blocked
    else:
        r = tuple(ranks) if len(ranks) > 1 else (ranks[0],) * (st.nmodes - 1)
        build, kernel = make_planned_tt, ttcore_blocked

    t0 = time.perf_counter()
    ws = build(st, r, device=device)
    for m in range(st.nmodes):
        p = ws.plan_for(m)
        print(f"mode {m}: {p.nblocks:,} blocks of {p.blk}, padding {p.padding_fraction():.1%}, "
              f"{p.output_tile_runs()} output-tile runs")
    print(f"plans built on {ws.device} in {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    state = decompose(st, r, format=algo, iters=iters, seed=0, planned=ws, device=ws.device,
                      verbose=True, trace=trace)
    if ws.device.type == "cuda":
        torch.cuda.synchronize()
    print(f"{algo} fit={state.fit_history[-1]:.4f} in {time.perf_counter() - t0:.2f}s "
          f"({kernel.launches} CUDA kernel launches)")
    if trace:
        from repro_torch.obs.calibrate import format_table, join_trace

        print(f"trace -> {trace}")
        print(format_table(join_trace(trace)))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises when no GPU is present)")
    ap.add_argument("--algo", default="cp", choices=("cp", "tucker", "tt"))
    ap.add_argument("--rank", default="16",
                    help="CP rank; Tucker core ranks (one int for every mode or a comma list); "
                         "or TT ranks (one int for every bond or a comma list of N-1)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export the headline decompose() call's trace as JSONL to PATH")
    a = ap.parse_args()
    main(a.device, a.algo, a.rank, a.iters, a.trace)
