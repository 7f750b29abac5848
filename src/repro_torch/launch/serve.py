"""Batched serving driver: prefill a batch of synthetic prompts, then decode
greedily, reporting per-phase token throughput.

Example (reduced config, CPU; drop --device for the GPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
      --batch 4 --prompt-len 64 --new-tokens 32 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import transformer as T
from ..serve.engine import make_decode_step, make_prefill_step

__all__ = ["main", "parse_args", "serve"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--attn-chunk", type=int, default=2048)
    ap.add_argument("--device", default=None, help="torch device (default: CUDA; 'cpu' to run there)")
    return ap.parse_args(argv)


def _clock(device: torch.device) -> float:
    """Host seconds, after the device has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def serve(cfg, *, batch: int, prompt_len: int, new_tokens: int, seed: int = 0, attn_chunk: int = 2048,
          device=None) -> dict:
    """Random weights and stub inputs from `seed`, one prefill of (batch,
    prompt_len) tokens and new_tokens - 1 greedy decode steps.  Returns the
    tokens (B, new_tokens), the last logits and the phases' seconds."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    params = T.init_params(cfg, generator=gen, device=device)
    B, S = batch, prompt_len
    inputs = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device, dtype=torch.int32)}
    if cfg.family == "audio":
        inputs["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen, device=device) * 0.1
    if cfg.family == "vlm":
        inputs["images"] = torch.randn((B, cfg.img_tokens, cfg.d_model), generator=gen, device=device) * 0.1

    prefill = make_prefill_step(cfg, cache_len=S + new_tokens, attn_chunk=attn_chunk)
    decode = make_decode_step(cfg)
    t0 = _clock(device)
    logits, caches = prefill(params, inputs)
    t_prefill = _clock(device) - t0
    cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    pos = torch.full((B,), S, dtype=torch.int64, device=device)
    out = [cur]
    t0 = _clock(device)
    for _ in range(new_tokens - 1):
        cur, logits, caches = decode(params, cur, pos, caches, inputs)
        out.append(cur)
        pos = pos + 1
    t_decode = _clock(device) - t0
    return {"tokens": torch.cat(out, dim=1), "logits": logits, "prefill_s": t_prefill,
            "decode_s": t_decode, "params": params, "inputs": inputs, "caches": caches}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mesh_data != 1 or args.mesh_model != 1:
        raise ValueError(f"--mesh-data {args.mesh_data} --mesh-model {args.mesh_model}: the port serves on "
                         "one device; meshes come with the LM stack's training slice (its sharding rules)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    run = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                seed=args.seed, attn_chunk=args.attn_chunk, device=args.device)
    B, S, t_prefill, t_decode = args.batch, args.prompt_len, run["prefill_s"], run["decode_s"]
    toks = run["tokens"].cpu().tolist()
    print(f"[serve] arch={cfg.name} batch={B} prompt={S} new={args.new_tokens}")
    print(f"[serve] prefill: {B*S/t_prefill:,.0f} tok/s ({t_prefill*1e3:.0f} ms)")
    print(f"[serve] decode:  {B*(args.new_tokens-1)/max(t_decode,1e-9):,.0f} tok/s "
          f"({t_decode/max(args.new_tokens-1,1)*1e3:.1f} ms/step)")
    print(f"[serve] sample continuation ids: {toks[0][:12]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
