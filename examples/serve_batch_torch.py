"""Batched serving example of the PyTorch port: prefill a batch of prompts
on a reduced qwen3 / jamba model and decode greedily, printing throughput
per phase.  The torch counterpart of `examples/serve_batch.py`.

  PYTHONPATH=src python examples/serve_batch_torch.py [--arch jamba-v0.1-52b]
  PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

Random weights and prompts from seed 0 (`repro_torch.launch.serve.serve`);
it serves on CUDA unless --device names another device, and raises
without a GPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None, help="torch device (default: CUDA; 'cpu' to run there)")
    return ap.parse_args(argv)


def main(argv=None, out: dict | None = None) -> int:
    """Serve once; `out`, where given, receives the run (`serve`'s dict)."""
    args = parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    cfg = get_config(args.arch).reduced()
    B, S, new = args.batch, args.prompt_len, args.new_tokens
    run = serve(cfg, batch=B, prompt_len=S, new_tokens=new, seed=0, attn_chunk=32, device=args.device)
    if out is not None:
        out.update(run)
    t_prefill, t_decode = run["prefill_s"], run["decode_s"]
    print(f"[serve] {args.arch} (reduced) batch={B} prompt={S} new={new}")
    print(f"[serve] prefill {B*S/t_prefill:,.0f} tok/s | decode {B*(new-1)/max(t_decode, 1e-9):,.0f} tok/s "
          f"({t_decode/max(new-1, 1)*1e3:.1f} ms/step)")
    print(f"[serve] first sequence continuation: {run['tokens'][0][:16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
