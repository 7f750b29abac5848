"""Batched serving: prefill + decode step builders and a host-side
generation loop.  The port of `repro.serve.engine`, without its sharding
specs (`cache_pspecs` comes with the LM sharding rules).

`cache_specs` mirrors models.transformer.init_caches on the `meta` device
(shapes and dtypes; a long cache is never allocated).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from ..models import transformer as T

__all__ = ["cache_specs", "make_prefill_step", "make_decode_step", "generate"]


def cache_specs(cfg, batch: int, cache_len: int) -> list[dict]:
    """init_caches on the `meta` device: shapes and dtypes, no allocation."""
    return T.init_caches(cfg, batch, cache_len, device="meta")


def make_prefill_step(cfg, *, cache_len: int | None = None, attn_chunk: int = 2048) -> Callable:
    """prefill_step(params, batch) -> (last logits (B, V), caches)."""

    def prefill_step(params, batch):
        return T.prefill(params, batch, cfg, cache_len=cache_len, attn_chunk=attn_chunk)

    return prefill_step


def make_decode_step(cfg, *, sample: str = "greedy") -> Callable:
    """decode_step(params, tokens (B,1), pos (B,), caches, batch) ->
    (next_tokens (B,1), logits, caches); the caches are updated in place."""
    if sample != "greedy":
        raise ValueError(f"unknown sampling {sample!r}: only 'greedy'")

    def decode(params, tokens, pos, caches, batch):
        logits, caches = T.decode_step(params, tokens, pos, caches, batch, cfg)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, caches

    return decode


def generate(params, batch: dict, cfg, *, max_new_tokens: int = 16, cache_margin: int = 0,
             attn_chunk: int = 2048, device=None) -> torch.Tensor:
    """Greedy generation driver (host loop over prefill and decode steps):
    (B, max_new_tokens) int32 token ids.  Runs on `device` (default CUDA;
    raises without a GPU unless a device is given), where `params` must
    already be; the batch is moved there."""
    device = resolve_device(device)
    if params["embed"].device != device:
        raise ValueError(f"params are on {params['embed'].device}, not on {device}")
    batch = {k: v.to(device) for k, v in batch.items()}
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = S + max_new_tokens + cache_margin
    prefill = make_prefill_step(cfg, cache_len=cache_len, attn_chunk=attn_chunk)
    decode = make_decode_step(cfg)
    logits, caches = prefill(params, batch)
    cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [cur]
    pos = torch.full((B,), S, dtype=torch.int64, device=device)
    for _ in range(max_new_tokens - 1):
        cur, _, caches = decode(params, cur, pos, caches, batch)
        out.append(cur)
        pos = pos + 1
    return torch.cat(out, dim=1)
