"""Attention: GQA self-attention (prefill + cached decode) and
cross-attention (whisper enc-dec, vlm image layers).  The port of
`repro.models.attention`.

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

Sharding (a `ShardingPlan` with a mesh; the tensors are DTensors): scores
are constrained to `plan.scores(H)`, the head dim where H divides the model
axis, else the query-chunk dim, as in the reference.  The masks and
position tables, built from shapes alone, are made replicated DTensors
beside the scores (`replicated`).  The decode step writes the new token's
K/V into the cache on the rank that holds its position (`_write_kv`).
"""
from __future__ import annotations

import torch

from ..dist.sharding import NOPLAN, P, ShardingPlan, is_dtensor, local_call, local_offset, replicated, valid_spec
from .layers import Params, apply_rope, dense_init, rmsnorm, rope_angles

__all__ = ["NEG_INF", "attn_init", "split_heads", "merge_heads", "qkv_project", "causal_attention", "full_attention",
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


def _whole_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """A DTensor whose last dim (n heads, flattened) is sharded over an axis
    that does not divide n, gathered over that axis (a shard boundary would
    fall inside a head); anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    mesh, last = t.device_mesh, t.dim() - 1
    split = [isinstance(p, Shard) and p.dim == last for p in t.placements]
    if any(s and n % mesh.size(i) for i, s in enumerate(split)):
        t = t.redistribute(mesh, [Replicate() if s else p for s, p in zip(split, t.placements)])
    return t


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd).  On a mesh, a feature dim sharded
    over an axis that does not divide n is gathered first (explicit)."""
    t = _whole_heads(t, n)
    return t.reshape(*t.shape[:-1], n, hd)


class _WholeHeadsGrad(torch.autograd.Function):
    """The identity, whose gradient is brought to whole heads
    (`_whole_heads`) before it flows back into the heads' unflatten."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.n), None


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, n, hd) -> (B, S, n * hd).  On a mesh, the gradient coming
    back (a row-parallel projection's input gradient is sharded on this
    feature dim) is gathered where the axis does not divide n (phi4-mini's
    24 and whisper's 20 heads on a 16-way model axis)."""
    *lead, n, hd = t.shape
    flat = t.reshape(*lead, n * hd)
    return _WholeHeadsGrad.apply(flat, n) if is_dtensor(flat) and flat.requires_grad else flat


def qkv_project(p: Params, x: torch.Tensor, n_heads: int, n_kv: int, hd: int, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project + reshape (+ optional per-head qk rmsnorm, qwen3-style)."""
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = split_heads(q, n_heads, hd)
    k = split_heads(k, n_kv, hd)
    v = split_heads(v, n_kv, hd)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, eps)
        k = rmsnorm(p["k_norm"], k, eps)
    return q, k, v


def _repeat_kv(t: torch.Tensor, G: int) -> torch.Tensor:
    """(B, S, KVH, hd) -> (B, S, KVH*G, hd); head h reads kv-head h // G
    (matches the (KVH, G) reshape convention of grouped GQA)."""
    return torch.repeat_interleave(t, G, dim=2) if G > 1 else t


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None,
            plan: ShardingPlan = NOPLAN) -> torch.Tensor:
    """Flat-head attention core.  q (B, Sq, H, hd), k/v (B, Sk, KVH, hd),
    mask broadcastable to (B, 1, Sq, Sk) with True = visible.  Returns
    (B, Sq, H, hd).

    On a mesh the scores take `plan.scores(H)`'s layout, and the core runs
    on each rank's part of it (`local_call`): its heads (q and K/V by head,
    K/V gathered whole where KVH does not divide the model axis and sliced
    to the rank's heads after the repeat), or, where H does not divide,
    its query rows (K/V whole).  The same flat-head math on every rank."""
    if plan.mesh is None:
        return _attend_local(q, k, v, mask)
    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    spec = valid_spec((B, H, Sq, k.shape[1]), plan.scores(H), plan.mesh)
    bsp, hsp, qsp = spec[0], spec[1], spec[2]
    kv_by_head = hsp is not None and valid_spec((KVH,), P(hsp), plan.mesh)[0] is not None
    kvs = P(bsp, None, hsp if kv_by_head else None, None)
    qs = P(bsp, qsp, hsp, None)
    ms = None if mask is None else P(bsp if mask.shape[0] > 1 else None, None, qsp if mask.shape[2] > 1 else None,
                                     None)
    n_local = H // (plan.mesh.size(plan.mesh.mesh_dim_names.index(hsp)) if isinstance(hsp, str) else 1)

    def core(ql, kl, vl, ml):
        if hsp is not None and not kv_by_head:  # this rank's heads of the repeated K/V
            lo = local_offset_of_heads(plan, hsp, n_local)
            G = H // KVH
            kl, vl = _repeat_kv(kl, G)[:, :, lo:lo + n_local], _repeat_kv(vl, G)[:, :, lo:lo + n_local]
        return _attend_local(ql, kl, vl, ml)

    return local_call(core, plan, [q, k, v, mask], [qs, kvs, kvs, ms], qs)


def local_offset_of_heads(plan: ShardingPlan, axis: str, n_local: int) -> int:
    """The first head of this rank's `n_local` heads along mesh axis `axis`."""
    mesh = plan.mesh
    return mesh.get_local_rank(mesh.mesh_dim_names.index(axis)) * n_local


def _attend_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
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


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, chunk: int = 2048,
                     plan: ShardingPlan = NOPLAN) -> torch.Tensor:
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
        # the same mask on every rank: a replicated DTensor on a mesh
        outs.append(_attend(qs, k[:, :kv_len], v[:, :kv_len], replicated(mask[None, None], q), plan))
    return torch.cat(outs, dim=1)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None = None, plan: ShardingPlan = NOPLAN) -> torch.Tensor:
    """Unchunked attention (encoder / cross-attention / short sequences);
    `mask` (Sq, Sk), True = visible."""
    return _attend(q, k, v, None if mask is None else replicated(mask[None, None], q), plan)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, plan: ShardingPlan = NOPLAN) -> torch.Tensor:
    """One-token attention over the KV cache (B, S, KVH, hd), masked to
    positions <= pos (B,)."""
    S = k_cache.shape[1]
    # cache positions: the same on every rank, replicated beside pos
    visible = replicated(torch.arange(S, device=pos.device), pos)[None, :] <= pos[:, None]  # (B, S)
    return _attend(q, k_cache, v_cache, visible[:, None, None, :], plan)


# ---------------------------------------------------------------------------
# Self-attention block entry points used by transformer.py
# ---------------------------------------------------------------------------


def _rope_qk(q, k, positions, cfg):
    if cfg.rope_theta > 0:
        cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k


def _positions(S: int, like: torch.Tensor) -> torch.Tensor:
    """arange(S) on `like`'s device: the same on every rank, so a
    replicated DTensor on a mesh."""
    return replicated(torch.arange(S, device=like.device), like)


def self_attention_train(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor | None = None, *,
                         chunk: int = 2048, causal: bool = True, plan: ShardingPlan = NOPLAN) -> torch.Tensor:
    """Full-sequence self-attention (the whisper encoder runs it with
    causal=False)."""
    S = x.shape[1]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qkv_project(p, x, H, KVH, hd, eps=cfg.norm_eps)
    if positions is None:
        positions = _positions(S, x)
    q, k = _rope_qk(q, k, positions, cfg)
    out = causal_attention(q, k, v, chunk=chunk, plan=plan) if causal else full_attention(q, k, v, plan=plan)
    return merge_heads(out) @ p["wo"].to(x.dtype)


def self_attention_prefill(p: Params, x: torch.Tensor, cfg, *, chunk: int = 2048,
                           plan: ShardingPlan = NOPLAN) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Prefill: causal attention + return the (rope'd) KV for the cache."""
    S = x.shape[1]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qkv_project(p, x, H, KVH, hd, eps=cfg.norm_eps)
    q, k = _rope_qk(q, k, _positions(S, x), cfg)
    out = causal_attention(q, k, v, chunk=chunk, plan=plan)
    y = merge_heads(out) @ p["wo"].to(x.dtype)
    return y, {"k": k, "v": v}


def _write_kv(cache_t: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """cache_t[b, pos[b]] = new[b, 0] for every b, in place.  On a mesh
    (DTensors) each rank writes the rows of its batch shard whose position
    falls in its part of the sequence (the cache may be sequence-sharded,
    `plan.kv_cache`): `new` and `pos` are brought to the cache's batch and
    head placements, and the write runs on the local shards."""
    if not is_dtensor(cache_t):
        rows = torch.arange(new.shape[0], device=pos.device)
        cache_t[rows, pos] = new[:, 0].to(cache_t.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = cache_t.device_mesh, cache_t.placements
    # the new row: the cache's placements with the sequence dim whole
    new_pl = [Replicate() if isinstance(x, Shard) and x.dim == 1 else x for x in pl]
    pos_pl = [x if isinstance(x, Shard) and x.dim == 0 else Replicate() for x in pl]
    local, n_l = cache_t.to_local(), new.redistribute(mesh, new_pl).to_local()
    pos_l = pos.redistribute(mesh, pos_pl).to_local()
    lo = local_offset(cache_t, 1)
    mine = (pos_l >= lo) & (pos_l < lo + local.shape[1])
    rows = torch.arange(n_l.shape[0], device=pos_l.device)[mine]
    local[rows, pos_l[mine] - lo] = n_l[mine, 0].to(local.dtype)


def self_attention_decode(p: Params, x: torch.Tensor, cache: dict[str, torch.Tensor], pos: torch.Tensor,
                          cfg, plan: ShardingPlan = NOPLAN) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decode step: write the new KV at `pos` (B,), attend over [0, pos].

    The write is an indexed write into the cache, in place: row pos[b] of
    batch b (on a mesh, by the rank holding that row: `_write_kv`).  The
    reference blends a one-hot over the whole cache; for a finite cache
    both give the same values, and this one touches B rows in place of the
    cache.  Every pos must be below the cache length."""
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qkv_project(p, x, H, KVH, hd, eps=cfg.norm_eps)
    q, k = _rope_qk(q, k, pos[:, None], cfg)  # cos/sin (B, 1, hd/2)
    _write_kv(cache["k"], k, pos)
    _write_kv(cache["v"], v, pos)
    out = decode_attention(q, cache["k"], cache["v"], pos, plan=plan)
    y = merge_heads(out) @ p["wo"].to(x.dtype)
    return y, {"k": cache["k"], "v": cache["v"]}


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder / llama-vision image layers)
# ---------------------------------------------------------------------------


def xattn_init(d: int, n_heads: int, n_kv: int, hd: int, *, generator: torch.Generator, device,
               dtype=torch.float32) -> Params:
    return attn_init(d, n_heads, n_kv, hd, generator=generator, device=device, dtype=dtype)


def cross_attention(p: Params, x: torch.Tensor, kv_src: torch.Tensor | None, cfg,
                    cached_kv: dict[str, torch.Tensor] | None = None, plan: ShardingPlan = NOPLAN
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Non-causal attention of x (B, Sq, D) into a memory stream kv_src
    (B, Skv, D).  Pass `cached_kv` during decode to skip reprojecting the
    (static) memory."""
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = split_heads(x @ p["wq"].to(x.dtype), H, hd)
    if cached_kv is None:
        if kv_src is None:
            raise ValueError("cross_attention needs kv_src or cached_kv")
        k = split_heads(kv_src @ p["wk"].to(x.dtype), KVH, hd)
        v = split_heads(kv_src @ p["wv"].to(x.dtype), KVH, hd)
        cached_kv = {"k": k, "v": v}
    out = full_attention(q, cached_kv["k"], cached_kv["v"], plan=plan)
    return merge_heads(out) @ p["wo"].to(x.dtype), cached_kv
