"""Attention: GQA self-attention (prefill + cached decode) and
cross-attention (whisper enc-dec, vlm image layers).  The port of
`repro.models.attention`, without its sharding constraints.

Scores are never materialized at (S x S): `causal_attention` walks query
chunks with a growing KV slice — block-lower-triangular, so the work is
the causal ~S^2/2 — and peak score memory is (B, H, chunk, S).  Scores are
computed flat over heads (KV repeated to H heads — the same math as grouped
GQA).

Scores are float32 whatever the compute dtype, as the reference's
`preferred_element_type=jnp.float32` product: `_attend` upcasts q and k
(exact for bfloat16) and multiplies in float32, so a bfloat16 product is
accumulated in float32.  TF32 must stay off for that product to be a
float32 one: it is torch's default (`torch.backends.cuda.matmul.allow_tf32
= False`), and the port never turns it on.
"""
from __future__ import annotations

import torch

from .layers import Params, apply_rope, dense_init, rmsnorm, rope_angles

__all__ = ["NEG_INF", "attn_init", "qkv_project", "causal_attention", "full_attention",
           "decode_attention", "self_attention_train", "self_attention_prefill",
           "self_attention_decode", "xattn_init", "cross_attention"]

NEG_INF = -1e30


def attn_init(d: int, n_heads: int, n_kv: int, hd: int, *, generator: torch.Generator, device,
              qkv_bias: bool = False, qk_norm: bool = False, dtype=torch.float32) -> Params:
    def dense(d_in, d_out):
        return dense_init(d_in, d_out, generator=generator, device=device, dtype=dtype)

    leaves = {"wq": dense(d, n_heads * hd), "wk": dense(d, n_kv * hd),
              "wv": dense(d, n_kv * hd), "wo": dense(n_heads * hd, d)}
    if qkv_bias:
        leaves["bq"] = torch.zeros((n_heads * hd,), dtype=dtype, device=device)
        leaves["bk"] = torch.zeros((n_kv * hd,), dtype=dtype, device=device)
        leaves["bv"] = torch.zeros((n_kv * hd,), dtype=dtype, device=device)
    if qk_norm:
        leaves["q_norm"] = Params(scale=torch.ones((hd,), dtype=dtype, device=device))
        leaves["k_norm"] = Params(scale=torch.ones((hd,), dtype=dtype, device=device))
    return Params(**leaves)


def qkv_project(p: Params, x: torch.Tensor, n_heads: int, n_kv: int, hd: int, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project + reshape (+ optional per-head qk rmsnorm, qwen3-style)."""
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, n_heads, hd)
    k = k.reshape(B, S, n_kv, hd)
    v = v.reshape(B, S, n_kv, hd)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, eps)
        k = rmsnorm(p["k_norm"], k, eps)
    return q, k, v


def _repeat_kv(t: torch.Tensor, G: int) -> torch.Tensor:
    """(B, S, KVH, hd) -> (B, S, KVH*G, hd); head h reads kv-head h // G
    (matches the (KVH, G) reshape convention of grouped GQA)."""
    return torch.repeat_interleave(t, G, dim=2) if G > 1 else t


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Flat-head attention core.  q (B, Sq, H, hd), k/v (B, Sk, KVH, hd),
    mask broadcastable to (B, 1, Sq, Sk) with True = visible.  Returns
    (B, Sq, H, hd)."""
    H, hd = q.shape[2], q.shape[3]
    G = H // k.shape[2]
    kr = _repeat_kv(k, G)
    vr = _repeat_kv(v, G)
    s = torch.einsum("bqhe,bshe->bhqs", q.float(), kr.float())
    s = s * (hd**-0.5)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshe->bqhe", w, vr)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, chunk: int = 2048) -> torch.Tensor:
    """Block-lower-triangular causal attention.  Query chunk c attends to the
    slice kv[: (c+1)*chunk]; softmax is exact per row (the full visible
    prefix is present), so no online-softmax carry is needed.  S must be a
    multiple of the chunk (after the chunk is cut to S)."""
    B, S, H, hd = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the attention chunk {chunk}")
    nchunks = S // chunk
    diag_mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    outs = []
    for c in range(nchunks):
        qs = q[:, c * chunk:(c + 1) * chunk]
        kv_len = (c + 1) * chunk
        # mask only the diagonal block; earlier blocks are fully visible
        mask = torch.cat([torch.ones((chunk, c * chunk), dtype=torch.bool, device=q.device), diag_mask], dim=1)
        outs.append(_attend(qs, k[:, :kv_len], v[:, :kv_len], mask[None, None]))
    return torch.cat(outs, dim=1)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Unchunked attention (encoder / cross-attention / short sequences);
    `mask` (Sq, Sk), True = visible."""
    return _attend(q, k, v, None if mask is None else mask[None, None])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """One-token attention over the KV cache (B, S, KVH, hd), masked to
    positions <= pos (B,)."""
    S = k_cache.shape[1]
    visible = torch.arange(S, device=pos.device)[None, :] <= pos[:, None]  # (B, S)
    return _attend(q, k_cache, v_cache, visible[:, None, None, :])


# ---------------------------------------------------------------------------
# Self-attention block entry points used by transformer.py
# ---------------------------------------------------------------------------


def _rope_qk(q, k, positions, cfg):
    if cfg.rope_theta > 0:
        cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k


def self_attention_train(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor | None = None, *,
                         chunk: int = 2048, causal: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (the whisper encoder runs it with
    causal=False)."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qkv_project(p, x, H, KVH, hd, eps=cfg.norm_eps)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k = _rope_qk(q, k, positions, cfg)
    out = causal_attention(q, k, v, chunk=chunk) if causal else full_attention(q, k, v)
    return out.reshape(B, S, H * hd) @ p["wo"].to(x.dtype)


def self_attention_prefill(p: Params, x: torch.Tensor, cfg, *,
                           chunk: int = 2048) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Prefill: causal attention + return the (rope'd) KV for the cache."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qkv_project(p, x, H, KVH, hd, eps=cfg.norm_eps)
    q, k = _rope_qk(q, k, torch.arange(S, device=x.device), cfg)
    out = causal_attention(q, k, v, chunk=chunk)
    y = out.reshape(B, S, H * hd) @ p["wo"].to(x.dtype)
    return y, {"k": k, "v": v}


def self_attention_decode(p: Params, x: torch.Tensor, cache: dict[str, torch.Tensor], pos: torch.Tensor,
                          cfg) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decode step: write the new KV at `pos` (B,), attend over [0, pos].

    The write is an indexed write into the cache, in place: row pos[b] of
    batch b.  The reference blends a one-hot over the whole cache; for a
    finite cache both give the same values, and this one touches B rows in
    place of the cache.  Every pos must be below the cache length."""
    B = x.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qkv_project(p, x, H, KVH, hd, eps=cfg.norm_eps)
    q, k = _rope_qk(q, k, pos[:, None], cfg)  # cos/sin (B, 1, hd/2)
    rows = torch.arange(B, device=pos.device)
    cache["k"][rows, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], pos)
    y = out.reshape(B, 1, H * hd) @ p["wo"].to(x.dtype)
    return y, {"k": cache["k"], "v": cache["v"]}


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder / llama-vision image layers)
# ---------------------------------------------------------------------------


def xattn_init(d: int, n_heads: int, n_kv: int, hd: int, *, generator: torch.Generator, device,
               dtype=torch.float32) -> Params:
    return attn_init(d, n_heads, n_kv, hd, generator=generator, device=device, dtype=dtype)


def cross_attention(p: Params, x: torch.Tensor, kv_src: torch.Tensor | None, cfg,
                    cached_kv: dict[str, torch.Tensor] | None = None
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Non-causal attention of x (B, Sq, D) into a memory stream kv_src
    (B, Skv, D).  Pass `cached_kv` during decode to skip reprojecting the
    (static) memory."""
    B, Sq, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(B, Sq, H, hd)
    if cached_kv is None:
        if kv_src is None:
            raise ValueError("cross_attention needs kv_src or cached_kv")
        Skv = kv_src.shape[1]
        k = (kv_src @ p["wk"].to(x.dtype)).reshape(B, Skv, KVH, hd)
        v = (kv_src @ p["wv"].to(x.dtype)).reshape(B, Skv, KVH, hd)
        cached_kv = {"k": k, "v": v}
    out = full_attention(q, cached_kv["k"], cached_kv["v"])
    return out.reshape(B, Sq, H * hd) @ p["wo"].to(x.dtype), cached_kv
