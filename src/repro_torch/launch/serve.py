"""Batched serving driver: prefill a batch of synthetic prompts, then decode
greedily, reporting per-phase token throughput.

On a mesh (``--mesh-data`` x ``--mesh-model``, one rank per device) when
the program runs under a process group (torchrun: NCCL on CUDA, gloo with
``--device cpu``; or begun by the caller), as `launch.train` decides; only
rank 0 prints.

Examples (reduced config, CPU; drop --device for the GPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
      --batch 4 --prompt-len 64 --new-tokens 32 --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve --arch qwen3-0.6b \
      --reduced --device cpu --mesh-data 2 --mesh-model 2 --prompt-len 16 --new-tokens 8 --attn-chunk 8
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..device import resolve_device
from ..dist.sharding import NOPLAN, ShardingPlan, full, make_plan
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
          device=None, plan: ShardingPlan = NOPLAN) -> dict:
    """Random weights and stub inputs from `seed`, one prefill of (batch,
    prompt_len) tokens and new_tokens - 1 greedy decode steps.  Returns the
    tokens (B, new_tokens), the last logits and the phases' seconds.  On a
    mesh every rank draws the same weights and keeps its shards of them
    (`convert.distribute_params`); the tokens come back whole."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    params = T.init_params(cfg, generator=gen, device=device)
    if plan.mesh is not None:
        from ..convert import distribute_params

        distribute_params(params, plan)
    B, S = batch, prompt_len
    inputs = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device, dtype=torch.int32)}
    if cfg.family == "audio":
        inputs["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen, device=device) * 0.1
    if cfg.family == "vlm":
        inputs["images"] = torch.randn((B, cfg.img_tokens, cfg.d_model), generator=gen, device=device) * 0.1

    prefill = make_prefill_step(cfg, plan, cache_len=S + new_tokens, attn_chunk=attn_chunk)
    decode = make_decode_step(cfg, plan)
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
    return {"tokens": torch.cat([full(t) for t in out], dim=1), "logits": logits, "prefill_s": t_prefill,
            "decode_s": t_decode, "params": params, "inputs": inputs, "caches": caches}


def main(argv=None, out: dict | None = None) -> int:
    """Serve once and print the reference's four lines; `out`, where given,
    receives the run (`serve`'s dict) and its "mesh" (None off a mesh)."""

    from .mesh import init_from_env
    from .train import _say, mesh_of

    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    init_from_env(args.device)  # under torchrun: before the device is chosen
    device = resolve_device(args.device)
    mesh = mesh_of(args, device)
    plan = NOPLAN if mesh is None else make_plan(mesh, cfg)
    run = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                seed=args.seed, attn_chunk=args.attn_chunk, device=device, plan=plan)
    if out is not None:
        out.update(run, mesh=mesh)
    B, S, t_prefill, t_decode = args.batch, args.prompt_len, run["prefill_s"], run["decode_s"]
    toks = run["tokens"].cpu().tolist()
    _say(f"[serve] arch={cfg.name} batch={B} prompt={S} new={args.new_tokens}")
    _say(f"[serve] prefill: {B*S/t_prefill:,.0f} tok/s ({t_prefill*1e3:.0f} ms)")
    _say(f"[serve] decode:  {B*(args.new_tokens-1)/max(t_decode,1e-9):,.0f} tok/s "
         f"({t_decode/max(args.new_tokens-1,1)*1e3:.1f} ms/step)")
    _say(f"[serve] sample continuation ids: {toks[0][:12]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
