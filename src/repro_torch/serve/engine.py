"""Batched serving: prefill + decode step builders and a host-side
generation loop.  The port of `repro.serve.engine`.

`cache_specs` mirrors models.transformer.init_caches on the `meta` device
(shapes and dtypes; a long cache is never allocated), and `cache_pspecs`
gives the matching specs from the ShardingPlan.  On a mesh the steps place
the batch (batch dim over the data axes) and the caches come out of
prefill at `cache_pspecs`' placements; the decode step's tokens stay
DTensors from step to step, and `generate` gathers them whole at the end.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from ..dist.sharding import NOPLAN, P, ShardingPlan, full, place_batch
from ..models import transformer as T

__all__ = ["cache_specs", "cache_pspecs", "make_prefill_step", "make_decode_step", "generate"]


def cache_specs(cfg, batch: int, cache_len: int) -> list[dict]:
    """init_caches on the `meta` device: shapes and dtypes, no allocation."""
    return T.init_caches(cfg, batch, cache_len, device="meta")


def cache_pspecs(cfg, plan: ShardingPlan) -> list[dict]:
    """Spec tree matching init_caches: KV (B,S,KVH,hd), ssm state
    (B,H,P,N), conv (B,K-1,C).  One dict per layer, so the reference's
    leading n_reps entry (its caches stack the repeats) is dropped."""

    def spec_for(name: str) -> P:
        if name in ("k", "v", "xk", "xv"):
            return plan.kv_cache(cfg.n_kv_heads)
        if name == "h":
            return plan.ssm_state()
        if name == "conv":
            return plan.conv_state()
        return P()

    return [{k: spec_for(k) for k in layer} for layer in cache_specs(cfg, 1, 8)]


def make_prefill_step(cfg, plan: ShardingPlan = NOPLAN, *, cache_len: int | None = None,
                      attn_chunk: int = 2048) -> Callable:
    """prefill_step(params, batch) -> (last logits (B, V), caches).  On a
    mesh the logits keep the vocabulary's masked padding columns."""

    def prefill_step(params, batch):
        return T.prefill(params, place_batch(batch, plan), cfg, cache_len=cache_len, plan=plan, attn_chunk=attn_chunk)

    return prefill_step


def make_decode_step(cfg, plan: ShardingPlan = NOPLAN, *, sample: str = "greedy") -> Callable:
    """decode_step(params, tokens (B,1), pos (B,), caches, batch) ->
    (next_tokens (B,1), logits, caches); the caches are updated in place."""
    if sample != "greedy":
        raise ValueError(f"unknown sampling {sample!r}: only 'greedy'")

    def decode(params, tokens, pos, caches, batch):
        logits, caches = T.decode_step(params, tokens, pos, caches, place_batch(batch, plan), cfg, plan)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, caches

    return decode


def generate(params, batch: dict, cfg, *, max_new_tokens: int = 16, cache_margin: int = 0,
             plan: ShardingPlan = NOPLAN, attn_chunk: int = 2048, device=None) -> torch.Tensor:
    """Greedy generation driver (host loop over prefill and decode steps):
    (B, max_new_tokens) int32 token ids, whole on every rank.  Runs on
    `device` (default CUDA; raises without a GPU unless a device is given),
    where `params` must already be (on a mesh: this rank's device); the
    batch is moved there."""
    device = resolve_device(device)
    if params["embed"].device != device:
        raise ValueError(f"params are on {params['embed'].device}, not on {device}")
    batch = {k: v.to(device) for k, v in batch.items()}
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = S + max_new_tokens + cache_margin
    prefill = make_prefill_step(cfg, plan, cache_len=cache_len, attn_chunk=attn_chunk)
    decode = make_decode_step(cfg, plan)
    logits, caches = prefill(params, batch)
    cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [cur]
    pos = torch.full((B,), S, dtype=torch.int64, device=device)
    for _ in range(max_new_tokens - 1):
        cur, _, caches = decode(params, cur, pos, caches, batch)
        out.append(cur)
        pos = pos + 1
    return torch.cat([full(t) for t in out], dim=1)
