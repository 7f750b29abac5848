"""Fault-tolerance demo of the PyTorch port: inject a node failure in the
middle of training and watch the supervisor restore from the atomic
checkpoint and finish, reproducing the exact batch stream.  The torch
counterpart of `examples/fault_tolerance_demo.py`.

  PYTHONPATH=src python examples/fault_tolerance_demo_torch.py [--device cpu]

It trains the reduced qwen3-0.6b for 24 steps through
`repro_torch.launch.train.main`, checkpointing every 8 steps; step 13
fails once, after the step-8 checkpoint, and the second attempt restores
step 8.  It trains on CUDA unless --device names another device, and
raises without a GPU.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: CUDA; 'cpu' to run there)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import main as train_main

    device = resolve_device(args.device)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ft_")
    try:
        rc = train_main([
            "--arch", "qwen3-0.6b", "--reduced",
            "--steps", "24", "--batch", "4", "--seq", "64",
            "--ckpt-dir", ckpt, "--ckpt-every", "8",
            "--fail-at-step", "13",  # dies after the step-8 checkpoint
            "--max-restarts", "2", "--log-every", "4",
            "--attn-chunk", "64", "--device", str(device),
        ])
        print(f"\n[demo] supervisor exit code: {rc} (0 = recovered from the injected failure and completed)")
        return rc
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
