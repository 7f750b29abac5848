"""Mixture-of-Experts with the paper's memory-controller dispatch.  The port
of `repro.models.moe`.

MoE token->expert dispatch is an spMTTKRP-shaped problem: a sparse
(token, expert) assignment stream drives gathers of dense rows.  The two
dispatch modes mirror the paper's Sec. 3 compute patterns:

  * ``remap``  (Approach 1, the paper's choice): stable counting sort of the
    assignment stream by expert id (the Tensor Remapper), giving contiguous
    per-expert buffers -> dense per-expert GEMMs, no (T, E, C) partials.
  * ``onehot`` (Approach 2 baseline): the one-hot dispatch einsum that
    materializes a (T, E, C) dispatch tensor.

Both drop the same assignments over capacity and give the same outputs up
to float rounding.  The dispatch functions take any leading batch dims
(the (G, Tg, D) groups of `moe_apply`), where the reference vmaps one group.

Nothing here sums in an order the hardware picks: the dropped rows of a
dispatch go to one spare row that is sliced off, and the combine un-permutes
each token's k weighted rows into (Tg, k, D) and sums over k (the
reference's scatter-add would be an atomic `index_add_` on the card).

Sharding (a plan with a mesh): tokens arrive grouped (G, Tg, D) with G on
the data axes, and the dispatch buffers (G, E, C, D) are constrained to G
on the data axes, replicated over the model axis, as in the reference.
The router's top-k sort and the dispatch / combine index work (sorts,
gathers, scatters with index tensors of their own) run on each rank's
local groups (`local_call`); the expert GEMMs between them are DTensor
ops, F sharded over the model axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.sharding import NOPLAN, P, ShardingPlan, is_dtensor, local_call, shard, valid_spec
from .layers import GLU_ACTS, Params, dense_init, gelu, is_glu

__all__ = ["moe_init", "router_topk", "capacity", "moe_apply", "dispatch_remap", "combine_remap",
           "dispatch_onehot", "experts_ffn"]


def moe_init(d: int, moe_cfg, act: str, *, generator: torch.Generator, device, dtype=torch.float32) -> Params:
    E, f = moe_cfg.num_experts, moe_cfg.d_ff

    def stack(din, dout):
        return torch.stack([dense_init(din, dout, generator=generator, device=device, dtype=dtype)
                            for _ in range(E)])

    leaves = {"router": dense_init(d, E, generator=generator, device=device, dtype=dtype, scale=0.02)}
    if is_glu(act):
        leaves["wg"] = stack(d, f)
    leaves["wu"] = stack(d, f)
    leaves["wd"] = stack(f, d)
    return Params(**leaves)


def capacity(tokens_per_group: int, moe_cfg) -> int:
    """Per-group expert capacity, padded to an 8-row sublane multiple."""
    c = int(tokens_per_group * moe_cfg.top_k * moe_cfg.capacity_factor / moe_cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights, ids) of the k largest probabilities, ties to the lower id."""
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], ids[..., :k]


def router_topk(p: Params, x: torch.Tensor, moe_cfg, plan: ShardingPlan = NOPLAN):
    """Router: softmax over experts, take top-k.  x: (..., Tg, D).
    Returns (expert_ids (..., Tg, k), combine_w (..., Tg, k), probs, aux).

    Ties go to the lower expert id, as `jax.lax.top_k` breaks them: a stable
    descending sort (`torch.topk` promises no order among equal values).
    On a mesh the sort runs on each rank's groups, experts whole."""
    logits = x.float() @ p["router"].float()  # (..., Tg, E)
    if plan.mesh is not None:
        logits = shard(logits, P(plan.dp, *([None] * (logits.dim() - 1))), plan)
    probs = torch.softmax(logits, dim=-1)
    grp = valid_spec(tuple(probs.shape), P(plan.dp, *([None] * (probs.dim() - 1))), plan.mesh)
    w, ids = local_call(lambda pr: _top_k(pr, moe_cfg.top_k), plan, [probs], [grp], (grp, grp))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalize over k
    # Aux losses: load-balance (Switch) + router z-loss.
    E = moe_cfg.num_experts
    me = probs.mean(dim=-2)  # (..., E) mean prob per expert
    ce = F.one_hot(ids[..., 0], E).float().mean(dim=-2)  # top-1 routed fraction
    lb = E * torch.sum(me * ce, dim=-1).mean()
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return ids, w, probs, {"load_balance": lb, "router_z": z}


# ---------------------------------------------------------------------------
# Approach 1: remap dispatch (counting sort by expert — the Tensor Remapper)
# ---------------------------------------------------------------------------


def dispatch_remap(x: torch.Tensor, ids: torch.Tensor, E: int, C: int):
    """Sort the (token, expert) assignment stream by expert id and scatter
    tokens into contiguous per-expert buffers.  x (..., Tg, D), ids
    (..., Tg, k).  Returns (buffers (..., E, C, D), meta for combine).
    Over-capacity assignments drop (standard MoE): their `dest` is E*C."""
    *lead, Tg, k = ids.shape
    D = x.shape[-1]
    e_flat = ids.reshape(*lead, Tg * k)
    tok_flat = torch.arange(Tg, device=ids.device).repeat_interleave(k).expand_as(e_flat)
    # --- the remap: stable counting sort by output coordinate (expert id) ---
    perm = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, -1, perm)
    tok_sorted = torch.gather(tok_flat, -1, perm)
    # position within expert = rank - start_of_expert_run (the pointer table)
    counts = F.one_hot(e_flat, E).sum(dim=-2)  # (..., E)
    starts = torch.cumsum(counts, dim=-1) - counts
    slot = torch.arange(Tg * k, device=ids.device) - torch.gather(starts, -1, e_sorted)
    keep = slot < C
    dest = torch.where(keep, e_sorted * C + slot, E * C)
    # rows land at dest; every dropped row lands in the one spare row E*C,
    # which is cut off: kept rows have distinct dests.
    rows = torch.gather(x, -2, tok_sorted[..., None].expand(*lead, Tg * k, D))
    buffers = x.new_zeros((*lead, E * C + 1, D))
    buffers.scatter_(-2, dest[..., None].expand(*lead, Tg * k, D), rows)
    meta = {"dest": dest, "tok_sorted": tok_sorted, "perm": perm, "keep": keep}
    return buffers[..., :E * C, :].reshape(*lead, E, C, D), meta


def combine_remap(expert_out: torch.Tensor, meta: dict, w_flat_unsorted: torch.Tensor, Tg: int) -> torch.Tensor:
    """Gather expert outputs back per assignment, weight, and sum the k
    contributions of each token.  expert_out (..., E, C, D); weights
    (..., Tg*k) in assignment order.  Dropped assignments read as zero."""
    *lead, E, C, D = expert_out.shape
    n = meta["dest"].shape[-1]
    flat = expert_out.reshape(*lead, E * C, D)
    safe = torch.clamp(meta["dest"], max=E * C - 1)
    rows = torch.gather(flat, -2, safe[..., None].expand(*lead, n, D))
    rows = torch.where(meta["keep"][..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    w = torch.gather(w_flat_unsorted, -1, meta["perm"])
    rows = rows * w[..., None].to(rows.dtype)
    # un-permute to assignment order (a permutation: no two rows collide),
    # then each token's k rows are adjacent
    by_assignment = torch.empty_like(rows).scatter_(-2, meta["perm"][..., None].expand(*lead, n, D), rows)
    return by_assignment.reshape(*lead, Tg, n // Tg, D).sum(dim=-2)


# ---------------------------------------------------------------------------
# Approach 2: one-hot dispatch (materialized (Tg, E, C) partials — baseline)
# ---------------------------------------------------------------------------


def onehot_slots(ids: torch.Tensor, E: int, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot, keep) of each assignment (..., Tg*k) in token-major order: its
    running rank within its expert, and whether it fits under C."""
    *lead, Tg, k = ids.shape
    e_flat = ids.reshape(*lead, Tg * k)
    oh_e = F.one_hot(e_flat, E)  # (..., Tg*k, E)
    pos = torch.cumsum(oh_e, dim=-2) - 1  # running rank within each expert
    slot = torch.sum(oh_e * pos, dim=-1)
    return slot, slot < C


def dispatch_onehot(x: torch.Tensor, ids: torch.Tensor, w: torch.Tensor, E: int, C: int):
    """Classic mesh-tf dispatch: build a (..., Tg, E, C) one-hot dispatch
    tensor.  Slot priority is token-major over the flattened (token,
    choice) stream — exactly the stable counting sort's order — so the two
    dispatch modes agree bit-for-bit including *which* assignments drop
    over capacity."""
    *lead, Tg, k = ids.shape
    e_flat = ids.reshape(*lead, Tg * k)  # token-major, same as dispatch_remap
    slot, keep = onehot_slots(ids, E, C)
    oh = (F.one_hot(e_flat, E).to(x.dtype)[..., :, None]
          * F.one_hot(torch.where(keep, slot, C), C + 1).to(x.dtype)[..., None, :C])  # (..., Tg*k, E, C)
    oh = oh.reshape(*lead, Tg, k, E, C)
    dispatch = oh.sum(dim=-3)
    combine = (oh.float() * w[..., None, None]).sum(dim=-3)
    return dispatch, combine


# ---------------------------------------------------------------------------
# Expert FFN + full layer
# ---------------------------------------------------------------------------


def experts_ffn(p: Params, buffers: torch.Tensor, act: str) -> torch.Tensor:
    """Dense per-expert GEMMs on (..., E, C, D) buffers."""
    dt = buffers.dtype
    if is_glu(act):
        g = GLU_ACTS[act](torch.einsum("...ecd,edf->...ecf", buffers, p["wg"].to(dt)))
        u = torch.einsum("...ecd,edf->...ecf", buffers, p["wu"].to(dt))
        h = g * u
    else:
        h = gelu(torch.einsum("...ecd,edf->...ecf", buffers, p["wu"].to(dt)))
    if is_dtensor(h):
        # On a mesh the hidden keeps the expert-major layout of the products
        # above, and the einsum below would view a local shard whose strides
        # cannot take it (grok-1 and jamba decode on the 16 x 16 mesh): laid
        # out afresh, the same numbers.
        h = h.contiguous()
    return torch.einsum("...ecf,efd->...ecd", h, p["wd"].to(dt))


def moe_apply(p: Params, x: torch.Tensor, moe_cfg, act: str, plan: ShardingPlan = NOPLAN):
    """Full MoE layer on (G, Tg, D) grouped tokens.  Dispatch mode per
    moe_cfg.dispatch.  Returns (out (G, Tg, D), aux).

    On a mesh the dispatch and the combine run on each rank's local groups
    (`local_call`), and the (G, E, C, D) buffers and expert outputs are
    constrained to G on the data axes, as in the reference."""
    G, Tg, D = x.shape
    E = moe_cfg.num_experts
    C = capacity(Tg, moe_cfg)
    ids, w, _, aux = router_topk(p, x, moe_cfg, plan)

    def grp(ndim: int, shape=None):
        spec = P(plan.dp, *([None] * (ndim - 1)))
        return spec if shape is None else valid_spec(shape, spec, plan.mesh)

    g3 = grp(3, (G, Tg, D))
    g4 = grp(4, (G, E, C, D))
    if moe_cfg.dispatch == "remap":
        meta: dict = {}

        def dispatch(xl, il):
            buffers, m = dispatch_remap(xl, il, E, C)
            meta.update(m)
            return buffers

        buffers = local_call(dispatch, plan, [x, ids], [g3, g3], g4)
        buffers = shard(buffers, grp(4), plan)  # (G, E, C, D): G stays on dp
        out_e = shard(experts_ffn(p, buffers, act), grp(4), plan)
        out = local_call(lambda oe, wl: combine_remap(oe, meta, wl.reshape(wl.shape[0], -1), Tg), plan,
                         [out_e, w], [g4, g3], g3)
    elif moe_cfg.dispatch == "onehot":
        dispatch, combine = local_call(lambda xl, il, wl: dispatch_onehot(xl, il, wl, E, C), plan,
                                       [x, ids, w], [g3, g3, g3], (g4, g4))
        buffers = shard(torch.einsum("gtec,gtd->gecd", dispatch, x), grp(4), plan)
        out_e = shard(experts_ffn(p, buffers, act), grp(4), plan)
        out = torch.einsum("gtec,gecd->gtd", combine.to(out_e.dtype), out_e)
    else:
        raise ValueError(f"unknown dispatch {moe_cfg.dispatch!r}")
    return shard(out, grp(3), plan), aux
