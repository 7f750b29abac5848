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

On a mesh (`plan.mesh` set) the parameters, the batch, the activations and
the caches are DTensors, and `shard` constrains them at the reference's
points: the residual stream to `plan.hidden()` after each block, the
encoder's memory to `plan.memory()`, the logits to `plan.logits()`, the
caches to `plan.kv_cache()` / `ssm_state()` / `conv_state()`.  The
embedding gather is `_ShardedEmbed` (its gradient is formed on each rank's
vocab slice); the logits keep their padding columns, masked.  Mamba layers
run on each rank's batch shard with their weights gathered
(`_mamba_local`): the SSD scan has no sharding rule.  Off a mesh every
function is the single-device path.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..dist.sharding import NOPLAN, P, ShardingPlan, is_dtensor, local_call, local_offset, place, replicated, \
    shard, valid_spec
from .attention import attn_init, cross_attention, split_heads, self_attention_decode, self_attention_prefill, \
    self_attention_train, xattn_init
from .layers import Params, dtype_of, embed, tree_of, embed_init, mlp, mlp_init, norm_apply, norm_init, \
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


def _apply_ffn(bp: Params, x: torch.Tensor, cfg, ffn: str, plan: ShardingPlan = NOPLAN):
    """Residual FFN half-block. Returns (x, aux)."""
    aux = {}
    if ffn == "none":
        return x, aux
    h = norm_apply(_norm_kind(cfg), bp["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        out, aux = moe_apply(bp["moe"], h, cfg.moe, cfg.act, plan)
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


def _mamba_local(fn: Callable, p, x: torch.Tensor, plan: ShardingPlan, *state, n_out: int,
                 state_specs: tuple = ()):
    """`fn(p, x, *state)` (a Mamba layer) on a mesh: on each rank's batch
    shard, its weights gathered whole (explicit, both axes: the SSD scan and
    the causal conv have no sharding rule), each weight's gradient this
    rank's part of the sum over the data axes (`local_call`).  `state`
    (caches) and the outputs after the first take `state_specs`, the first
    output the batch spec of `plan.hidden()`.  Off a mesh: `fn(p, x,
    *state)`."""
    if plan.mesh is None:
        return fn(p, x, *state)
    names = [n for n, _ in _named_leaves(p)]
    leaves = [t for _, t in _named_leaves(p)]
    whole = [P(*([None] * t.dim())) for t in leaves]
    xs = valid_spec(tuple(x.shape), P(plan.dp, None, None), plan.mesh)
    sts = [valid_spec(tuple(t.shape), P(plan.dp, *([None] * (t.dim() - 1))), plan.mesh) for t in state]

    def run(xl, *rest):
        sl, pl = rest[:len(state)], rest[len(state):]
        return fn(tree_of(dict(zip(names, pl))), xl, *sl)

    outs = (xs,) + tuple(state_specs[:n_out - 1])
    return local_call(run, plan, [x, *state, *leaves], [xs, *sts, *whole], outs if n_out > 1 else xs)


def _named_leaves(p, prefix: str = ""):
    """(dotted name, tensor) of a `Params` node or a nested dict."""
    items = p.items() if isinstance(p, dict) else list(p._parameters.items()) + list(p._modules.items())
    for k, v in items:
        if isinstance(v, torch.Tensor):
            yield prefix + k, v
        else:
            yield from _named_leaves(v, f"{prefix}{k}.")


def encode_audio(params: Params, frames: torch.Tensor, cfg, plan: ShardingPlan = NOPLAN) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (conv stub).
    Takes gradients when they are on (training); the serving callers run
    it under `torch.no_grad`."""
    nk = _norm_kind(cfg)
    enc = params["encoder"]
    pos = sinusoid_positions(frames.shape[1], cfg.d_model, device=frames.device).to(frames.dtype)
    x = frames + replicated(pos, frames)  # the same table on every rank

    def layer(bp):
        def run(x):
            h = norm_apply(nk, bp["norm1"], x, cfg.norm_eps)
            x = x + self_attention_train(bp["attn"], h, cfg, causal=False, plan=plan)
            h = norm_apply(nk, bp["norm2"], x, cfg.norm_eps)
            return shard(x + mlp(bp["mlp"], h, cfg.act), plan.memory(), plan), {}

        return run

    x, _ = _run_layers(cfg, [layer(bp) for bp in enc["blocks"]], x, 1)
    return norm_apply(nk, enc["norm_post"], x, cfg.norm_eps)


class _ShardedEmbed(torch.autograd.Function):
    """The embedding gather on a mesh, whose gradient stays sharded over the
    vocabulary (the port of the reference's `_make_sharded_embed`).

    The reference writes the gather's cotangent as one_hot(ids)^T @ g so
    that XLA's partitioner keeps V sharded instead of replicating a dense
    (V, D) scatter.  Here each rank holds its slice of the table and forms
    that product on it: one_hot(ids)^T restricted to the rank's vocabulary
    rows, times g, evaluated as the indexed accumulate it equals (the op
    autograd uses for a plain gather, so one rank gives the single-device
    gradient bit for bit), without the (T, V / tp) one-hot.  The result is
    this rank's part of the sum over the data axes that split the tokens,
    redistributed to the table's placements (a reduce-scatter under fsdp).

    Forward: the table gathered over the data axes (fsdp) and kept sharded
    over the model axis; a vocabulary-sharded table gives each rank the
    rows of its own ids and zeros elsewhere, summed over the model axis (a
    Partial placement), exactly the gathered rows."""

    @staticmethod
    def forward(ctx, table, ids, plan):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh, names = plan.mesh, plan.mesh.mesh_dim_names
        data = set(plan.data_axes())
        tab_pl = [Replicate() if n in data else pl for n, pl in zip(names, table.placements)]
        tab = table.redistribute(mesh, tab_pl).to_local()
        ids_pl = [pl if n in data else Replicate() for n, pl in zip(names, ids.placements)]
        ids_l = ids.redistribute(mesh, ids_pl).to_local()
        lo, vocab_sharded = local_offset(table, 0), tab.shape[0] != table.shape[0]
        if vocab_sharded:
            mine = (ids_l >= lo) & (ids_l < lo + tab.shape[0])
            rows = tab[torch.where(mine, ids_l - lo, 0)]
            out_l = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        else:
            mine, out_l = None, tab[ids_l]
        out_pl = []
        for n, ip, tp_ in zip(names, ids_pl, tab_pl):
            if n in data:
                out_pl.append(ip)
            elif isinstance(tp_, Shard) and tp_.dim == 1:
                out_pl.append(Shard(2))
            elif vocab_sharded and isinstance(tp_, Shard):
                out_pl.append(Partial())
            else:
                out_pl.append(Replicate())
        ctx.plan, ctx.table_pl, ctx.tab_pl, ctx.tab_shape = plan, table.placements, tab_pl, tuple(tab.shape)
        ctx.global_shape, ctx.lo, ctx.mine, ctx.vocab_sharded = tuple(table.shape), lo, mine, vocab_sharded
        ctx.ids_l, ctx.ids_pl, ctx.out_pl = ids_l, ids_pl, out_pl
        shape = tuple(ids.shape) + (table.shape[1],)
        return DTensor.from_local(out_l, mesh, out_pl, run_check=False, shape=torch.Size(shape),
                                  stride=(shape[1] * shape[2], shape[2], 1))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        plan = ctx.plan
        mesh, names, data = plan.mesh, plan.mesh.mesh_dim_names, set(plan.data_axes())
        g_pl = [Replicate() if isinstance(p, Partial) else p for p in ctx.out_pl]
        gl = g.redistribute(mesh, g_pl).to_local()
        grad = torch.zeros(ctx.tab_shape, dtype=gl.dtype, device=gl.device)
        if ctx.vocab_sharded:
            grad.index_put_((ctx.ids_l[ctx.mine] - ctx.lo,), gl[ctx.mine], accumulate=True)
        else:
            grad.index_put_((ctx.ids_l,), gl, accumulate=True)
        # a part of the sum over each data axis that splits the tokens
        grad_pl = [Partial() if n in data and isinstance(ip, Shard) else p
                   for n, ip, p in zip(names, ctx.ids_pl, ctx.tab_pl)]
        grad = DTensor.from_local(grad, mesh, grad_pl, run_check=False, shape=torch.Size(ctx.global_shape),
                                  stride=(ctx.global_shape[1], 1))
        return grad.redistribute(mesh, ctx.table_pl), None, None


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg, plan: ShardingPlan = NOPLAN,
                  pos: torch.Tensor | None = None) -> torch.Tensor:
    """Token embedding (+ sinusoid positions for rope-free archs).  `pos`
    (B,) selects per-batch positions during decode; None = arange(S)."""
    cd = dtype_of(cfg.compute_dtype)
    if plan.mesh is not None:
        tokens = tokens if is_dtensor(tokens) else place(tokens, P(plan.dp, None), plan)
        x = _ShardedEmbed.apply(params["embed"], tokens, plan).to(cd)
    else:
        x = embed(params["embed"], tokens, cd)
    if cfg.family == "audio" or cfg.rope_theta == 0:
        if pos is None:  # the same table on every rank: replicated on a mesh
            tab = sinusoid_positions(tokens.shape[1], cfg.d_model, device=x.device).to(cd)
            x = x + replicated(tab, x)[None]
        else:  # the rows of the reference's 65,536-row table that pos selects
            rows = sinusoid_rows(torch.clamp(pos, max=SINUSOID_ROWS - 1), cfg.d_model)
            x = x + rows[:, None].to(cd)
    return shard(x, plan.hidden(), plan)


def lm_logits(params: Params, h: torch.Tensor, cfg, plan: ShardingPlan = NOPLAN) -> torch.Tensor:
    """Final-norm + unembed.  The weights are rounded to the compute dtype
    and the product accumulates in float32 (both operands upcast, TF32
    off); logits come out float32 with the vocabulary padding sliced off.
    On a mesh the padding columns stay, masked to -1e30 (slicing the
    TP-sharded vocabulary would reshard it), as in the reference."""
    h = norm_apply(_norm_kind(cfg), params["norm_f"], h, cfg.norm_eps)
    w = params["lm_head"] if "lm_head" in params else params["embed"]
    logits = torch.einsum("bsd,vd->bsv", h.float(), w.to(h.dtype).float())
    if cfg.vocab_padded != cfg.vocab:
        if plan.mesh is None:
            logits = logits[..., :cfg.vocab]
        else:  # the same mask on every rank: replicated
            pad_mask = replicated(torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab, logits)
            logits = torch.where(pad_mask, logits, -1e30)
    return shard(logits, plan.logits(), plan)


def _memory_of(params: Params, batch: dict, cfg, plan: ShardingPlan = NOPLAN) -> torch.Tensor | None:
    cd = dtype_of(cfg.compute_dtype)
    if cfg.family == "audio":
        return encode_audio(params, batch["frames"].to(cd), cfg, plan)
    if cfg.family == "vlm":
        return batch["images"].to(cd)
    return None


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _apply_block_train(bp: Params, x: torch.Tensor, cfg, mixer: str, ffn: str,
                       memory: torch.Tensor | None, plan: ShardingPlan, attn_chunk: int):
    nk = _norm_kind(cfg)
    h = norm_apply(nk, bp["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        x = x + self_attention_train(bp["attn"], h, cfg, chunk=attn_chunk, plan=plan)
    elif mixer == "mamba":
        x = x + _mamba_local(lambda p, h_: mamba_train(p, h_, cfg), bp["mamba"], h, plan, n_out=1)
    elif mixer == "xattn":
        y, _ = cross_attention(bp["xattn"], h, memory, cfg, plan=plan)
        x = x + torch.tanh(bp["gate_attn"]).to(x.dtype) * y
    if cfg.family == "audio":  # decoder cross-attn into encoder memory
        hx = norm_apply(nk, bp["norm_x"], x, cfg.norm_eps)
        y, _ = cross_attention(bp["xattn"], hx, memory, cfg, plan=plan)
        x = x + y
    x, aux = _apply_ffn(bp, x, cfg, ffn, plan)
    return shard(x, plan.hidden(), plan), aux


def forward_hidden(params: Params, batch: dict, cfg, plan: ShardingPlan = NOPLAN, *, attn_chunk: int = 2048
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Token stream -> (final hidden states (B, S, D), the MoE aux losses
    summed over the layers: {"load_balance", "router_z"}, zeros without
    MoE)."""
    pattern = cfg.pattern_kinds()
    memory = _memory_of(params, batch, cfg, plan)
    x = _embed_tokens(params, batch["tokens"], cfg, plan)

    def layer(i, bp):
        mixer, ffn = pattern[i % len(pattern)]
        return lambda x: _apply_block_train(bp, x, cfg, mixer, ffn, memory, plan, attn_chunk)

    x, auxes = _run_layers(cfg, [layer(i, bp) for i, bp in enumerate(params["blocks"])], x, len(pattern))
    aux = {}
    for key in ("load_balance", "router_z"):
        vals = [a[key] for a in auxes if key in a]
        zero = replicated(torch.zeros((), dtype=torch.float32, device=x.device), x)
        aux[key] = torch.stack(vals).sum() if vals else zero
    return x, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token CE.  labels < 0 are ignored.  Returns (sum, count).
    On a mesh the logits keep their masked padding columns past `vocab`
    and their vocabulary dim may be sharded: the gold logit is taken on the
    rank holding it (`_gold`), and the log-sum-exp of a vocabulary held
    whole reads the `vocab` real columns, the single-device sum."""
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    lse = _lse(logits, vocab)
    gold = _gold(logits, safe)
    nll = torch.where(valid, lse - gold, replicated(torch.zeros((), dtype=lse.dtype, device=lse.device), lse))
    return nll.sum(), valid.sum()


def _lse(logits: torch.Tensor, vocab: int | None) -> torch.Tensor:
    """logsumexp over the last dim.  A DTensor whose vocabulary dim no rank
    splits is reduced on each rank over its first `vocab` columns (the
    padding columns add exact zeros, but a longer row sums in another
    order); a split vocabulary by DTensor's rule, the padding masked."""
    if not is_dtensor(logits) or vocab is None or _axes_of(logits, logits.dim() - 1, split=True):
        return torch.logsumexp(logits, dim=-1)
    spec = P(*[_axes_of(logits, d) for d in range(logits.dim() - 1)], None)
    out = P(*spec[:-1])
    return local_call(lambda lg: torch.logsumexp(lg[..., :vocab], dim=-1), ShardingPlan(mesh=logits.device_mesh),
                      [logits], [spec], out)


def _axes_of(t: torch.Tensor, dim: int, split: bool = False):
    """The mesh axes that shard dim `dim` of the DTensor `t`, as a spec
    entry (with `split`, only the axes of more than one rank)."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    names = tuple(n for i, (n, p) in enumerate(zip(mesh.mesh_dim_names, t.placements))
                  if isinstance(p, Shard) and p.dim == dim and not (split and mesh.size(i) == 1))
    return None if not names else names[0] if len(names) == 1 else names


def _gold(logits: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """logits[..., safe]: a gather, or on a mesh each rank's share of it
    from its vocabulary slice (zeros elsewhere, summed over the model axis:
    exact, one rank holds each label)."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, safe[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = logits.device_mesh
    lo = local_offset(logits, 2)
    lab_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in logits.placements]
    lg, sl = logits.to_local(), safe.redistribute(mesh, lab_pl).to_local()
    mine = (sl >= lo) & (sl < lo + lg.shape[-1])
    picked = torch.gather(lg, -1, torch.where(mine, sl - lo, 0)[..., None])[..., 0]
    picked = torch.where(mine, picked, torch.zeros((), dtype=picked.dtype, device=picked.device))
    out_pl = [Partial() if isinstance(p, Shard) and p.dim == 2 else p for p in logits.placements]
    return DTensor.from_local(picked, mesh, out_pl, run_check=False, shape=safe.shape,
                              stride=(safe.shape[1], 1))


def apply_train(params: Params, batch: dict, cfg, plan: ShardingPlan = NOPLAN, *, attn_chunk: int = 2048
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full forward + masked CE loss (+ MoE aux): loss = ce + 0.01 lb +
    1e-3 z.  Metrics: ce, tokens, load_balance, router_z.  The train step
    microbatches around this, so logits exist for one microbatch at a
    time."""
    h, aux = forward_hidden(params, batch, cfg, plan, attn_chunk=attn_chunk)
    logits = lm_logits(params, h, cfg, plan)
    nll_sum, count = cross_entropy(logits, batch["labels"], cfg.vocab if plan.mesh is not None else None)
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
    k = split_heads(memory @ bp["xattn"]["wk"].to(memory.dtype), kvh, hd)
    v = split_heads(memory @ bp["xattn"]["wv"].to(memory.dtype), kvh, hd)
    return k, v


@torch.no_grad()
def prefill(params: Params, batch: dict, cfg, cache_len: int | None = None, plan: ShardingPlan = NOPLAN, *,
            attn_chunk: int = 2048) -> tuple[torch.Tensor, list[dict]]:
    """Process the whole prompt; return (last-position logits (B, V), caches).

    KV caches are allocated at `cache_len` (>= prompt length) and written in
    [0, S).  Mamba caches carry the post-prompt state.  On a mesh the
    caches come out with `cache_pspecs`' placements: K/V are brought to
    batch-only sharding (heads whole), padded, then sharded to
    `plan.kv_cache()` (a local slice), the reference's two steps."""
    pattern = cfg.pattern_kinds()
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} is shorter than the prompt ({S})")
    memory = _memory_of(params, batch, cfg, plan)
    x = _embed_tokens(params, tokens, cfg, plan)
    cd = dtype_of(cfg.compute_dtype)
    nk = _norm_kind(cfg)
    rep4 = P(plan.dp, None, None, None)
    caches = []
    for i, bp in enumerate(params["blocks"]):
        mixer, ffn = pattern[i % len(pattern)]
        h = norm_apply(nk, bp["norm1"], x, cfg.norm_eps)
        cache: dict[str, torch.Tensor] = {}
        if mixer == "attn":
            y, kv = self_attention_prefill(bp["attn"], h, cfg, chunk=attn_chunk, plan=plan)
            x = x + y
            for key in ("k", "v"):
                t = F.pad(shard(kv[key].to(cd), rep4, plan), (0, 0, 0, 0, 0, cache_len - S))
                cache[key] = shard(t, plan.kv_cache(cfg.n_kv_heads), plan)
        elif mixer == "mamba":
            y, hstate, conv = _mamba_local(lambda p, h_: _flat_state(mamba_train(p, h_, cfg, return_state=True)),
                                           bp["mamba"], h, plan, n_out=3,
                                           state_specs=_batch_specs(plan, h.shape[0], (4, 3)))
            x = x + y
            cache["h"] = shard(hstate, plan.ssm_state(), plan)
            cache["conv"] = shard(conv.to(cd), plan.conv_state(), plan)
        elif mixer == "xattn":
            xk, xv = _project_xkv(bp, memory, cfg)
            y, _ = cross_attention(bp["xattn"], h, None, cfg, {"k": xk, "v": xv}, plan=plan)
            x = x + torch.tanh(bp["gate_attn"]).to(x.dtype) * y
            kvs = plan.kv_cache(cfg.n_kv_heads)
            cache["xk"], cache["xv"] = shard(xk.to(cd), kvs, plan), shard(xv.to(cd), kvs, plan)
        if cfg.family == "audio":
            xk, xv = _project_xkv(bp, memory, cfg)
            hx = norm_apply(nk, bp["norm_x"], x, cfg.norm_eps)
            y, _ = cross_attention(bp["xattn"], hx, None, cfg, {"k": xk, "v": xv}, plan=plan)
            x = x + y
            kvs = plan.kv_cache(cfg.n_kv_heads)
            cache["xk"], cache["xv"] = shard(xk.to(cd), kvs, plan), shard(xv.to(cd), kvs, plan)
        x, _ = _apply_ffn(bp, x, cfg, ffn, plan)
        x = shard(x, plan.hidden(), plan)
        caches.append(cache)
    logits = lm_logits(params, x[:, -1:], cfg, plan)[:, 0]
    return logits, caches


def _flat_state(out):
    y, (h, conv) = out
    return y, h, conv


def _batch_specs(plan: ShardingPlan, batch: int, ndims) -> tuple:
    """Batch-only specs (batch over the data axes where it divides) for
    tensors of the given ranks."""
    return tuple(valid_spec((batch,) + (1,) * (n - 1), P(plan.dp, *([None] * (n - 1))), plan.mesh)
                 for n in ndims)


@torch.no_grad()
def decode_step(params: Params, tokens: torch.Tensor, pos: torch.Tensor, caches: list[dict], batch: dict,
                cfg, plan: ShardingPlan = NOPLAN) -> tuple[torch.Tensor, list[dict]]:
    """One new token (B, 1) at positions pos (B,) against the caches.
    Returns (logits (B, V), caches): the same list, its KV caches written
    in place at pos and its Mamba states replaced (on a mesh, at their
    `cache_pspecs` placements)."""
    pattern = cfg.pattern_kinds()
    nk = _norm_kind(cfg)
    if plan.mesh is not None:
        tokens = tokens if is_dtensor(tokens) else place(tokens, P(plan.dp, None), plan)
        pos = pos if is_dtensor(pos) else place(pos, P(plan.dp), plan)
    x = _embed_tokens(params, tokens, cfg, plan, pos=pos)
    for i, bp in enumerate(params["blocks"]):
        mixer, ffn = pattern[i % len(pattern)]
        cache = caches[i]
        h = norm_apply(nk, bp["norm1"], x, cfg.norm_eps)
        if mixer == "attn":
            y, _ = self_attention_decode(bp["attn"], h, cache, pos, cfg, plan=plan)
            x = x + y
        elif mixer == "mamba":
            specs = _batch_specs(plan, h.shape[0], (4, 3))
            y, hs, conv = _mamba_local(lambda p, h_, hc, cc: _flat_decode(mamba_decode(p, h_, {"h": hc, "conv": cc},
                                                                                      cfg)),
                                       bp["mamba"], h, plan, cache["h"], cache["conv"], n_out=3, state_specs=specs)
            x = x + y
            cache.update(h=shard(hs, plan.ssm_state(), plan), conv=shard(conv, plan.conv_state(), plan))
        elif mixer == "xattn":
            y, _ = cross_attention(bp["xattn"], h, None, cfg, {"k": cache["xk"], "v": cache["xv"]}, plan=plan)
            x = x + torch.tanh(bp["gate_attn"]).to(x.dtype) * y
        if cfg.family == "audio":
            hx = norm_apply(nk, bp["norm_x"], x, cfg.norm_eps)
            y, _ = cross_attention(bp["xattn"], hx, None, cfg, {"k": cache["xk"], "v": cache["xv"]}, plan=plan)
            x = x + y
        x, _ = _apply_ffn(bp, x, cfg, ffn, plan)
    logits = lm_logits(params, x, cfg, plan)[:, 0]
    return logits, caches


def _flat_decode(out):
    y, new = out
    return y, new["h"], new["conv"]
