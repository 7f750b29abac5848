"""Unified model: one composable stack covering every assigned family.  The
port of `repro.models.transformer`.

  dense / moe          decoder-only LM (GQA attn + MLP/MoE)
  ssm                  Mamba2 stack (attention-free)
  hybrid (jamba)       Mamba + attn 7:1 interleave, MoE every other layer
  audio (whisper)      enc-dec; encoder consumes stub frame embeddings
  vlm (llama-vision)   decoder LM with cross-attn image layers (stub patches)

Structure: the layer pattern repeats with period ``cfg.period``.  The
reference stacks each period position's parameters over the repeats and
scans; here `params["blocks"]` is a `ModuleList` in depth order and the
layers are walked in a loop: layer i is position i % period of repeat
i // period (`convert.params_from_numpy` restacks the reference's tree).
Caches are a list in the same depth order, one dict per layer.

Entry points:
  init_params / abstract_params          parameters (on a device / on meta)
  apply_train -> (loss, metrics)         next-token CE (+ MoE aux losses)
  prefill    -> (last_logits, caches)    full-prompt pass, caches filled
  decode_step-> (logits, caches)         one token against the caches
  init_caches                            zeroed decode state

Training (`forward_hidden`, `apply_train`) walks the same layers.  With
`cfg.remat` each layer runs under `torch.utils.checkpoint` (its activations
are recomputed in the backward pass); with `cfg.remat_group` = g > 1
dividing the repeats, groups of g repeats are checkpointed too, each layer
inside them as well.  Remat changes memory, never numbers.  `scan_unroll`
and `barrier_xs` shape the reference's XLA graph only and have no effect.
The model functions take any tree that answers `p["name"]`, `"name" in p`
and iterates `p["blocks"]`: the `Params` modules, or the train step's
plain dicts of cast tensors that require grad.

Memory streams (whisper frames, vlm images) are taken in the compute
dtype.  The reference keeps them as given, so float32 stubs under bfloat16
compute turn its hidden state float32 and its layer scan refuses them.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import attn_init, cross_attention, self_attention_decode, self_attention_prefill, \
    self_attention_train, xattn_init
from .layers import Params, dtype_of, embed, embed_init, mlp, mlp_init, norm_apply, norm_init, \
    sinusoid_positions, sinusoid_rows
from .moe import moe_apply, moe_init
from .ssm import mamba_decode, mamba_init, mamba_init_cache, mamba_train

__all__ = ["init_params", "abstract_params", "apply_train", "forward_hidden", "cross_entropy", "prefill",
           "decode_step", "init_caches", "lm_logits", "encode_audio"]

#: Rows of the reference's decode-side sinusoid table; positions past it
#: read its last row.
SINUSOID_ROWS = 1 << 16


def _norm_kind(cfg) -> str:
    return getattr(cfg, "norm", "rms")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(cfg, mixer: str, ffn: str, *, generator: torch.Generator, device, dtype) -> Params:
    """One layer's parameters (pre-norm residual block)."""
    d = cfg.d_model
    nk = _norm_kind(cfg)
    kw = dict(generator=generator, device=device, dtype=dtype)
    p: dict[str, Any] = {"norm1": norm_init(nk, d, device=device, dtype=dtype)}
    if mixer == "attn":
        p["attn"] = attn_init(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, **kw)
    elif mixer == "mamba":
        p["mamba"] = mamba_init(d, cfg.ssm, **kw)
    elif mixer == "xattn":
        p["xattn"] = xattn_init(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, **kw)
        p["gate_attn"] = torch.zeros((), dtype=torch.float32, device=device)
        p["gate_ffn"] = torch.zeros((), dtype=torch.float32, device=device)
    if cfg.family == "audio":  # whisper decoder: self-attn + cross-attn + mlp
        p["xattn"] = xattn_init(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, **kw)
        p["norm_x"] = norm_init(nk, d, device=device, dtype=dtype)
    if ffn != "none":
        p["norm2"] = norm_init(nk, d, device=device, dtype=dtype)
        if ffn == "moe":
            p["moe"] = moe_init(d, cfg.moe, cfg.act, **kw)
        else:
            p["mlp"] = mlp_init(d, cfg.d_ff, cfg.act, **kw)
    return Params(**p)


def _encoder_init(cfg, *, generator: torch.Generator, device, dtype) -> Params:
    """Whisper-style encoder: full-attention + MLP blocks over frames."""
    nk = _norm_kind(cfg)
    d = cfg.d_model
    blocks = nn.ModuleList(
        Params(norm1=norm_init(nk, d, device=device, dtype=dtype),
               attn=attn_init(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, generator=generator, device=device,
                              dtype=dtype),
               norm2=norm_init(nk, d, device=device, dtype=dtype),
               mlp=mlp_init(d, cfg.d_ff, cfg.act, generator=generator, device=device, dtype=dtype))
        for _ in range(cfg.encoder_layers))
    return Params(blocks=blocks, norm_post=norm_init(nk, d, device=device, dtype=dtype))


def init_params(cfg, *, generator: torch.Generator | None = None, device=None) -> Params:
    """The model's parameters drawn from `generator` (default: seed 0 on
    `device`) on `device` (default CUDA; raises without a GPU unless a
    device is given).  The reference draws other numbers (its own PRNG);
    `convert.params_from_numpy` carries its parameters across."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device).manual_seed(0)
    dtype = dtype_of(cfg.param_dtype)
    pattern = cfg.pattern_kinds()
    kw = dict(generator=generator, device=device, dtype=dtype)
    p: dict[str, Any] = {
        "embed": embed_init(cfg.vocab_padded, cfg.d_model, **kw),
        "blocks": nn.ModuleList(_block_init(cfg, *pattern[i % len(pattern)], **kw)
                                for i in range(cfg.n_layers)),
        "norm_f": norm_init(_norm_kind(cfg), cfg.d_model, device=device, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(cfg.vocab_padded, cfg.d_model, **kw)
    if cfg.family == "audio":
        p["encoder"] = _encoder_init(cfg, **kw)
    return Params(**p)


def abstract_params(cfg) -> Params:
    """The parameter tree on the `meta` device: shapes and dtypes, no
    allocation."""
    return init_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# block pieces
# ---------------------------------------------------------------------------


def _apply_ffn(bp: Params, x: torch.Tensor, cfg, ffn: str):
    """Residual FFN half-block. Returns (x, aux)."""
    aux = {}
    if ffn == "none":
        return x, aux
    h = norm_apply(_norm_kind(cfg), bp["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        out, aux = moe_apply(bp["moe"], h, cfg.moe, cfg.act)
    else:
        out = mlp(bp["mlp"], h, cfg.act)
    return x + out, aux


def _chain(fns: list[Callable]) -> Callable:
    """x through `fns` (each x -> (x, aux)) in turn: x -> (x, [aux, ...])."""

    def run(x):
        auxes = []
        for f in fns:
            x, aux = f(x)
            auxes.append(aux)
        return x, auxes

    return run


def _checkpointed(fn: Callable) -> Callable:
    return lambda x: checkpoint(fn, x, use_reentrant=False)


def _run_layers(cfg, layers: list[Callable], x: torch.Tensor, period: int) -> tuple[torch.Tensor, list[dict]]:
    """x through `layers` (each x -> (x, aux)) in depth order, under
    `torch.utils.checkpoint` where cfg.remat asks and gradients are on.
    Returns (x, the layers' aux dicts)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return _chain(layers)(x)
    fns = [_checkpointed(f) for f in layers]
    grp = getattr(cfg, "remat_group", 0) * period
    if grp <= period or len(fns) % grp:
        return _chain(fns)(x)
    # two-level (sqrt) remat: only the group boundaries are saved; a group's
    # layers are recomputed, each inside its own checkpoint
    x, groups = _chain([_checkpointed(_chain(fns[i:i + grp])) for i in range(0, len(fns), grp)])(x)
    return x, [aux for g in groups for aux in g]


def encode_audio(params: Params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (conv stub).
    Takes gradients when they are on (training); the serving callers run
    it under `torch.no_grad`."""
    nk = _norm_kind(cfg)
    enc = params["encoder"]
    x = frames + sinusoid_positions(frames.shape[1], cfg.d_model, device=frames.device).to(frames.dtype)

    def layer(bp):
        def run(x):
            h = norm_apply(nk, bp["norm1"], x, cfg.norm_eps)
            x = x + self_attention_train(bp["attn"], h, cfg, causal=False)
            h = norm_apply(nk, bp["norm2"], x, cfg.norm_eps)
            return x + mlp(bp["mlp"], h, cfg.act), {}

        return run

    x, _ = _run_layers(cfg, [layer(bp) for bp in enc["blocks"]], x, 1)
    return norm_apply(nk, enc["norm_post"], x, cfg.norm_eps)


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg, pos: torch.Tensor | None = None) -> torch.Tensor:
    """Token embedding (+ sinusoid positions for rope-free archs).  `pos`
    (B,) selects per-batch positions during decode; None = arange(S)."""
    cd = dtype_of(cfg.compute_dtype)
    x = embed(params["embed"], tokens, cd)
    if cfg.family == "audio" or cfg.rope_theta == 0:
        if pos is None:
            x = x + sinusoid_positions(tokens.shape[1], cfg.d_model, device=x.device).to(cd)[None]
        else:  # the rows of the reference's 65,536-row table that pos selects
            rows = sinusoid_rows(torch.clamp(pos, max=SINUSOID_ROWS - 1), cfg.d_model)
            x = x + rows[:, None].to(cd)
    return x


def lm_logits(params: Params, h: torch.Tensor, cfg) -> torch.Tensor:
    """Final-norm + unembed.  The weights are rounded to the compute dtype
    and the product accumulates in float32 (both operands upcast, TF32
    off); logits come out float32 with the vocabulary padding sliced off."""
    h = norm_apply(_norm_kind(cfg), params["norm_f"], h, cfg.norm_eps)
    w = params["lm_head"] if "lm_head" in params else params["embed"]
    logits = torch.einsum("bsd,vd->bsv", h.float(), w.to(h.dtype).float())
    if cfg.vocab_padded != cfg.vocab:
        logits = logits[..., :cfg.vocab]
    return logits


def _memory_of(params: Params, batch: dict, cfg) -> torch.Tensor | None:
    cd = dtype_of(cfg.compute_dtype)
    if cfg.family == "audio":
        return encode_audio(params, batch["frames"].to(cd), cfg)
    if cfg.family == "vlm":
        return batch["images"].to(cd)
    return None


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _apply_block_train(bp: Params, x: torch.Tensor, cfg, mixer: str, ffn: str,
                       memory: torch.Tensor | None, attn_chunk: int):
    nk = _norm_kind(cfg)
    h = norm_apply(nk, bp["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        x = x + self_attention_train(bp["attn"], h, cfg, chunk=attn_chunk)
    elif mixer == "mamba":
        x = x + mamba_train(bp["mamba"], h, cfg)
    elif mixer == "xattn":
        y, _ = cross_attention(bp["xattn"], h, memory, cfg)
        x = x + torch.tanh(bp["gate_attn"]).to(x.dtype) * y
    if cfg.family == "audio":  # decoder cross-attn into encoder memory
        hx = norm_apply(nk, bp["norm_x"], x, cfg.norm_eps)
        y, _ = cross_attention(bp["xattn"], hx, memory, cfg)
        x = x + y
    return _apply_ffn(bp, x, cfg, ffn)


def forward_hidden(params: Params, batch: dict, cfg, *, attn_chunk: int = 2048
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Token stream -> (final hidden states (B, S, D), the MoE aux losses
    summed over the layers: {"load_balance", "router_z"}, zeros without
    MoE)."""
    pattern = cfg.pattern_kinds()
    memory = _memory_of(params, batch, cfg)
    x = _embed_tokens(params, batch["tokens"], cfg)

    def layer(i, bp):
        mixer, ffn = pattern[i % len(pattern)]
        return lambda x: _apply_block_train(bp, x, cfg, mixer, ffn, memory, attn_chunk)

    x, auxes = _run_layers(cfg, [layer(i, bp) for i, bp in enumerate(params["blocks"])], x, len(pattern))
    aux = {}
    for key in ("load_balance", "router_z"):
        vals = [a[key] for a in auxes if key in a]
        aux[key] = torch.stack(vals).sum() if vals else torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token CE.  labels < 0 are ignored.  Returns (sum, count)."""
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - gold, torch.zeros((), dtype=lse.dtype, device=lse.device))
    return nll.sum(), valid.sum()


def apply_train(params: Params, batch: dict, cfg, *, attn_chunk: int = 2048
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full forward + masked CE loss (+ MoE aux): loss = ce + 0.01 lb +
    1e-3 z.  Metrics: ce, tokens, load_balance, router_z.  The train step
    microbatches around this, so logits exist for one microbatch at a
    time."""
    h, aux = forward_hidden(params, batch, cfg, attn_chunk=attn_chunk)
    logits = lm_logits(params, h, cfg)
    nll_sum, count = cross_entropy(logits, batch["labels"])
    loss = nll_sum / torch.clamp(count, min=1)
    metrics = {"ce": loss, "tokens": count}
    loss = loss + 0.01 * aux["load_balance"] + 1e-3 * aux["router_z"]
    metrics.update(aux)
    return loss, metrics


# ---------------------------------------------------------------------------
# serve: caches, prefill, decode
# ---------------------------------------------------------------------------


def _block_cache(cfg, mixer: str, batch: int, cache_len: int, mem_len: int, dtype, device) -> dict:
    """Zeroed cache for one layer."""
    cache: dict[str, torch.Tensor] = {}
    kvh, hd = cfg.n_kv_heads, cfg.hd
    if mixer == "attn":
        cache["k"] = torch.zeros((batch, cache_len, kvh, hd), dtype=dtype, device=device)
        cache["v"] = torch.zeros((batch, cache_len, kvh, hd), dtype=dtype, device=device)
    elif mixer == "mamba":
        cache.update(mamba_init_cache(batch, cfg.d_model, cfg.ssm, dtype, device=device))
    if mixer == "xattn" or cfg.family == "audio":
        cache["xk"] = torch.zeros((batch, mem_len, kvh, hd), dtype=dtype, device=device)
        cache["xv"] = torch.zeros((batch, mem_len, kvh, hd), dtype=dtype, device=device)
    return cache


def init_caches(cfg, batch: int, cache_len: int, dtype=None, *, device=None) -> list[dict]:
    """Zeroed decode state: one dict per layer, in depth order (default
    device CUDA; `device="meta"` gives shapes and dtypes only)."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.compute_dtype)
    pattern = cfg.pattern_kinds()
    mem_len = cfg.encoder_seq if cfg.family == "audio" else (cfg.img_tokens or 1)
    return [_block_cache(cfg, pattern[i % len(pattern)][0], batch, cache_len, mem_len, dtype, device)
            for i in range(cfg.n_layers)]


def _project_xkv(bp: Params, memory: torch.Tensor, cfg):
    kvh, hd = cfg.n_kv_heads, cfg.hd
    B, Skv, _ = memory.shape
    k = (memory @ bp["xattn"]["wk"].to(memory.dtype)).reshape(B, Skv, kvh, hd)
    v = (memory @ bp["xattn"]["wv"].to(memory.dtype)).reshape(B, Skv, kvh, hd)
    return k, v


@torch.no_grad()
def prefill(params: Params, batch: dict, cfg, cache_len: int | None = None, *,
            attn_chunk: int = 2048) -> tuple[torch.Tensor, list[dict]]:
    """Process the whole prompt; return (last-position logits (B, V), caches).

    KV caches are allocated at `cache_len` (>= prompt length) and written in
    [0, S).  Mamba caches carry the post-prompt state."""
    pattern = cfg.pattern_kinds()
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the prompt ({S})")
    memory = _memory_of(params, batch, cfg)
    x = _embed_tokens(params, tokens, cfg)
    cd = dtype_of(cfg.compute_dtype)
    nk = _norm_kind(cfg)
    caches = []
    for i, bp in enumerate(params["blocks"]):
        mixer, ffn = pattern[i % len(pattern)]
        h = norm_apply(nk, bp["norm1"], x, cfg.norm_eps)
        cache: dict[str, torch.Tensor] = {}
        if mixer == "attn":
            y, kv = self_attention_prefill(bp["attn"], h, cfg, chunk=attn_chunk)
            x = x + y
            cache["k"] = F.pad(kv["k"].to(cd), (0, 0, 0, 0, 0, cache_len - S))
            cache["v"] = F.pad(kv["v"].to(cd), (0, 0, 0, 0, 0, cache_len - S))
        elif mixer == "mamba":
            y, (hstate, conv) = mamba_train(bp["mamba"], h, cfg, return_state=True)
            x = x + y
            cache["h"] = hstate
            cache["conv"] = conv.to(cd)
        elif mixer == "xattn":
            xk, xv = _project_xkv(bp, memory, cfg)
            y, _ = cross_attention(bp["xattn"], h, None, cfg, {"k": xk, "v": xv})
            x = x + torch.tanh(bp["gate_attn"]).to(x.dtype) * y
            cache["xk"], cache["xv"] = xk.to(cd), xv.to(cd)
        if cfg.family == "audio":
            xk, xv = _project_xkv(bp, memory, cfg)
            hx = norm_apply(nk, bp["norm_x"], x, cfg.norm_eps)
            y, _ = cross_attention(bp["xattn"], hx, None, cfg, {"k": xk, "v": xv})
            x = x + y
            cache["xk"], cache["xv"] = xk.to(cd), xv.to(cd)
        x, _ = _apply_ffn(bp, x, cfg, ffn)
        caches.append(cache)
    logits = lm_logits(params, x[:, -1:], cfg)[:, 0]
    return logits, caches


@torch.no_grad()
def decode_step(params: Params, tokens: torch.Tensor, pos: torch.Tensor, caches: list[dict], batch: dict,
                cfg) -> tuple[torch.Tensor, list[dict]]:
    """One new token (B, 1) at positions pos (B,) against the caches.
    Returns (logits (B, V), caches): the same list, its KV caches written
    in place at pos and its Mamba states replaced."""
    pattern = cfg.pattern_kinds()
    nk = _norm_kind(cfg)
    x = _embed_tokens(params, tokens, cfg, pos=pos)
    for i, bp in enumerate(params["blocks"]):
        mixer, ffn = pattern[i % len(pattern)]
        cache = caches[i]
        h = norm_apply(nk, bp["norm1"], x, cfg.norm_eps)
        if mixer == "attn":
            y, _ = self_attention_decode(bp["attn"], h, cache, pos, cfg)
            x = x + y
        elif mixer == "mamba":
            y, new = mamba_decode(bp["mamba"], h, cache, cfg)
            x = x + y
            cache.update(new)
        elif mixer == "xattn":
            y, _ = cross_attention(bp["xattn"], h, None, cfg, {"k": cache["xk"], "v": cache["xv"]})
            x = x + torch.tanh(bp["gate_attn"]).to(x.dtype) * y
        if cfg.family == "audio":
            hx = norm_apply(nk, bp["norm_x"], x, cfg.norm_eps)
            y, _ = cross_attention(bp["xattn"], hx, None, cfg, {"k": cache["xk"], "v": cache["xv"]})
            x = x + y
        x, _ = _apply_ffn(bp, x, cfg, ffn)
    logits = lm_logits(params, x, cfg)[:, 0]
    return logits, caches
