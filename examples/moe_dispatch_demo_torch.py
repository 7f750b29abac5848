"""The paper's memory-controller insight applied to MoE, in the PyTorch
port: dispatch tokens to experts by Approach 1 (remap / counting sort:
contiguous per-expert buffers, no partial tensors) and by Approach 2
(one-hot dispatch tensors), and check that they compute the same layer
while moving very different traffic.  The torch counterpart of
`examples/moe_dispatch_demo.py`.

  PYTHONPATH=src python examples/moe_dispatch_demo_torch.py [--device cpu]

Per dispatch mode it prints the layer's FLOPs (torch.utils.flop_counter's
formulas: the matrix products), the bytes its ops move (every op's tensor
inputs and outputs, views left out: `launch.dryrun.StepCounters`, counted
from the tensors as they run, where the reference prints XLA's `bytes
accessed`), and its wall time (the mean of 10 calls after a warm-up, the
device synchronized).  It runs on CUDA unless --device names another
device, and raises without a GPU.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None, out: dict | None = None) -> int:
    """Run both dispatch modes; `out`, where given, receives per mode its
    "flops", "bytes" and "wall_s", and "max_abs_diff" between them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: CUDA; 'cpu' to run there)")
    args = ap.parse_args(argv)
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import MoEConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch.dryrun import StepCounters
    from repro_torch.models.moe import moe_apply, moe_init

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    G, Tg, D, E, k = 2, 512, 128, 8, 2
    x = torch.randn((G, Tg, D), generator=torch.Generator(device).manual_seed(0), device=device) * 0.3
    outs, report = {}, {}
    with torch.no_grad():
        for dispatch in ("remap", "onehot"):
            cfg = MoEConfig(num_experts=E, top_k=k, d_ff=256, capacity_factor=1.25, dispatch=dispatch)
            params = moe_init(D, cfg, "silu", generator=torch.Generator(device).manual_seed(0), device=device)
            with FlopCounterMode(display=False) as flops:
                moe_apply(params, x, cfg, "silu")
            with StepCounters() as moved:
                moe_apply(params, x, cfg, "silu")
            sync()
            t0 = time.perf_counter()
            for _ in range(10):
                y = moe_apply(params, x, cfg, "silu")[0]
            sync()
            wall = (time.perf_counter() - t0) / 10
            outs[dispatch] = y
            report[dispatch] = {"flops": flops.get_total_flops(), "bytes": moved.bytes_accessed, "wall_s": wall}
            print(f"{dispatch:7s}: bytes={moved.bytes_accessed:.3e} flops={flops.get_total_flops():.3e} "
                  f"wall={wall*1e6:.0f}us")
    err = float((outs["remap"] - outs["onehot"]).abs().max())
    print(f"max |remap - onehot| = {err:.2e}  (identical math, different memory schedule: the paper's "
          f"Approach 1 vs 2, Sec. 3)")
    if out is not None:
        out.update(report, max_abs_diff=err)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
