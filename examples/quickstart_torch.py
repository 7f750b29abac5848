"""Quickstart for the PyTorch port: CP-ALS on the planned MTTKRP kernel.

The torch counterpart of `examples/quickstart.py --algo cp`.
`repro_torch.api.decompose(st, rank, format="cp")` builds one BlockPlan per
output mode on the device (the Tensor Remapper), then runs every ALS
iteration through the hand-written CUDA MTTKRP kernel.

  PYTHONPATH=src python examples/quickstart_torch.py                 # GPU: nell2_like, rank 16
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu    # CPU: tiny, rank 16

On the CPU the kernel's plain PyTorch version runs instead.
"""
import argparse
import time

import torch


def main(device: str | None, iters: int) -> None:
    from repro_torch.api import decompose
    from repro_torch.core.coo import frostt_like
    from repro_torch.kernels.mttkrp import mttkrp_blocked
    from repro_torch.kernels.ops import make_planned_cp_als

    preset = "tiny" if device == "cpu" else "nell2_like"
    st = frostt_like(preset)
    print(f"tensor {preset}: shape={st.shape} nnz={st.nnz:,} density={st.density:.2e}")

    rank = 16
    t0 = time.perf_counter()
    ws = make_planned_cp_als(st, rank, device=device)
    for m in range(st.nmodes):
        p = ws.plan_for(m)
        print(f"mode {m}: {p.nblocks:,} blocks of {p.blk}, padding {p.padding_fraction():.1%}, "
              f"{p.output_tile_runs()} output-tile runs")
    print(f"plans built on {ws.device} in {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    state = decompose(st, rank, format="cp", iters=iters, seed=0, planned=ws,
                      device=ws.device, verbose=True)
    if ws.device.type == "cuda":
        torch.cuda.synchronize()
    print(f"CP-ALS fit={state.fit_history[-1]:.4f} in {time.perf_counter() - t0:.2f}s "
          f"({mttkrp_blocked.launches} CUDA kernel launches)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises when no GPU is present)")
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args()
    main(a.device, a.iters)
