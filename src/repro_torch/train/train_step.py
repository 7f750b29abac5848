"""Microbatched training step, on one device or on a mesh: the port of
`repro.train.train_step`.

It follows the reference step for step:
  * the float32 masters of rank 2 or more (the reference's rank: a layer's
    tensor counts the layer axis, `train/stacks.py`) are cast to the compute
    dtype once a step, and gradients are taken against those cast copies,
    so they arrive in the compute dtype;
  * with num_microbatches = n > 1 the batch splits into (n, B/n) and the
    gradients accumulate in `accum_dtype` (bfloat16 for fsdp archs, float32
    otherwise), then divide by n; the loss is the microbatches' mean and
    the other metrics are the last microbatch's;
  * then int8 error feedback (`dist/compression.py`, when asked), then
    AdamW on the float32 masters (`train/optimizer.py`).

The cast copies reach the model as a tree of plain dicts (lists for the
layers) whose leaves are fresh tensors that require grad; the model's
functions read it as they read `Params`.  The master `Params` tree stays
float32 and is updated in place, as are the optimizer's moments (the
reference donates its state to jit); nothing holds a graph across steps.

`TrainState.opt` is keyed by the reference's leaf names, each layer-stacked
leaf a list of per-layer tensors in repeat order ({"m", "v", "step"}, and
"ef" with compression); `TrainState.rng` is the `torch.Generator` the
parameters were drawn from (the reference keeps its PRNG key there).

On a mesh (`plan.mesh` set) the parameters, the moments, the batch and the
activations are DTensors (`convert.distribute_train_state` places a state
by `param_pspecs` / `opt_pspecs`).  Every rank reads the whole batch from
the deterministic pipeline; each microbatch is split from it before it is
placed (batch over the data axes).  Gradients and the microbatch
accumulator are redistributed to the parameters' placements
(`constrain_like_params`, the reference's sharding constraint: where a
gradient arrives as a partial sum over the data axes, this is its
all-reduce or reduce-scatter), and AdamW keeps each moment on its own
placements.  The metrics come back whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..dist.compression import compress_decompress, init_error_feedback
from ..dist.sharding import NOPLAN, ShardingPlan, full, is_dtensor, param_pspecs, place_batch, placements, \
    valid_spec
from ..models import transformer as T
from ..models.layers import Params, dtype_of, tree_of
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .stacks import is_layer_leaf, reference_leaves

__all__ = ["TrainState", "init_train_state", "make_train_step", "master_leaves", "cast_leaves",
           "value_and_grad", "param_shardings_of", "constrain_like_params"]


@dataclasses.dataclass
class TrainState:
    params: Params
    opt: dict
    rng: torch.Generator


def master_leaves(params: Params, cfg) -> dict:
    """The master tensors under the reference's leaf names (stacks as
    lists of the parameters themselves, not copies)."""
    return reference_leaves(dict(params.named_parameters()), cfg.period)


def init_train_state(cfg, opt_cfg: AdamWConfig, *, generator: torch.Generator | None = None, device=None,
                     compress_grads: bool = False, plan: ShardingPlan = NOPLAN) -> TrainState:
    """Parameters drawn from `generator` (default: seed 0 on `device`) on
    `device` (default CUDA; raises without a GPU unless a device is given),
    and a zeroed optimizer state (with compress_grads, a zeroed int8
    residual too).  On a mesh every rank draws the same whole state and
    keeps its shards of it (`convert.distribute_train_state`)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    params = T.init_params(cfg, generator=generator, device=device)
    leaves = master_leaves(params, cfg)
    opt = adamw_init(leaves, opt_cfg)
    if compress_grads:  # the residual exists from step 0: a stable state structure
        opt = init_error_feedback(opt, leaves)
    state = TrainState(params=params, opt=opt, rng=generator)
    if plan.mesh is not None:
        from ..convert import distribute_train_state

        state = distribute_train_state(state, cfg, plan, opt_cfg)
    return state


def cast_leaves(params: Params, cfg) -> dict[str, torch.Tensor]:
    """The step's compute copies by the port's names: float32 leaves of the
    reference's rank 2 or more cast to the compute dtype, the others as they
    are; each a new leaf tensor that requires grad."""
    cd = dtype_of(cfg.compute_dtype)
    out = {}
    for name, t in params.named_parameters():
        c = t.detach()
        if c.dtype == torch.float32 and c.dim() + is_layer_leaf(name) >= 2:
            c = c.to(cd)
        out[name] = c.requires_grad_(True)
    return out


def value_and_grad(cfg, leaves: dict[str, torch.Tensor], batch: dict, *, attn_chunk: int = 2048,
                   plan: ShardingPlan = NOPLAN) -> tuple[torch.Tensor, dict, dict[str, torch.Tensor]]:
    """`apply_train` on the tree of `leaves` (tensors that require grad, by
    the port's names): (loss, metrics, gradients by name), all detached.
    A leaf the loss does not reach gets a zero gradient."""
    with torch.enable_grad():
        loss, metrics = T.apply_train(tree_of(leaves), batch, cfg, plan, attn_chunk=attn_chunk)
        ts = list(leaves.values())
        grads = torch.autograd.grad(loss, ts, allow_unused=True)
    grads = {name: torch.zeros_like(t) if g is None else g for (name, t), g in zip(leaves.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _on(batch: dict, device: torch.device) -> dict:
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _microbatch(v: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Microbatch i of n of a batch tensor: rows [i B/n, (i+1) B/n) of a
    whole one.  Of a DTensor (a batch placed over the data axes, as the dry
    run passes it) rows [i b/n, (i+1) b/n) of each rank's shard of b rows,
    so the split communicates nothing: the same rows as a whole batch's
    microbatches where no rank splits the batch dim, else grouped per
    shard."""
    if not is_dtensor(v):
        return v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
    from torch.distributed.tensor import DTensor

    loc = v.to_local()
    if loc.shape[0] % n:
        raise ValueError(f"a batch shard of {loc.shape[0]} rows is not divisible by num_microbatches {n}")
    part = loc.reshape((n, loc.shape[0] // n) + loc.shape[1:])[i]
    shape = (v.shape[0] // n,) + tuple(v.shape[1:])
    return DTensor.from_local(part, v.device_mesh, v.placements, run_check=False, shape=torch.Size(shape),
                              stride=part.stride())


def param_shardings_of(params, plan: ShardingPlan) -> dict | None:
    """{the port's parameter name: its DTensor placements} (`param_pspecs`,
    divisibility-filtered), or None off a mesh."""
    if plan.mesh is None:
        return None
    named = dict(params.named_parameters()) if hasattr(params, "named_parameters") else params
    specs = param_pspecs(named, plan)
    return {k: placements(valid_spec(tuple(t.shape), specs[k], plan.mesh), plan.mesh) for k, t in named.items()}


def constrain_like_params(tree: dict, shardings: dict | None) -> dict:
    """Pin a tree of gradients (or accumulators) by the port's names to the
    parameters' placements: a gradient that arrives as a partial sum (over
    the data axes, or the model axis) is reduced here, then sliced to its
    parameter's shards (the reduce-scatter of fsdp).  The partial sums are
    reduced together, one all-reduce per set of mesh dims and dtype over
    all the leaves' local data laid end to end (the bucket of DDP), and
    each leaf then takes its own placement locally.  The identity off a
    mesh (`shardings` None)."""
    if shardings is None:
        return tree
    from torch.distributed.tensor import DTensor, Partial, Replicate

    groups: dict = {}
    for k, g in tree.items():
        dims = tuple(i for i, p in enumerate(g.placements) if isinstance(p, Partial))
        if dims:
            groups.setdefault((g.device_mesh, dims, g.dtype), []).append(k)
    out = dict(tree)
    for (mesh, dims, _), keys in groups.items():
        locals_ = [tree[k].to_local() for k in keys]
        flat = torch.cat([t.reshape(-1) for t in locals_])
        part = [Partial() if i in dims else Replicate() for i in range(mesh.ndim)]
        flat = DTensor.from_local(flat, mesh, part, run_check=False).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()
        offset = 0
        for k, t in zip(keys, locals_):
            g = tree[k]
            pl = [Replicate() if i in dims else p for i, p in enumerate(g.placements)]
            red = flat[offset:offset + t.numel()].view(t.shape)
            offset += t.numel()
            out[k] = DTensor.from_local(red, mesh, pl, run_check=False, shape=g.shape, stride=g.stride())
    return {k: g.redistribute(g.device_mesh, shardings[k]) for k, g in out.items()}


def make_train_step(cfg, opt_cfg: AdamWConfig, plan: ShardingPlan = NOPLAN, *, num_microbatches: int = 1,
                    attn_chunk: int = 2048, compress_grads: bool = False, accum_dtype: str | None = None
                    ) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``.  The batch
    (numpy arrays or tensors, leading dimension B divisible by
    num_microbatches) is moved to the parameters' device (on a mesh: each
    microbatch placed over the data axes; a batch of DTensors already
    placed there is split on each rank's shard, `_microbatch`); the state
    is updated in place and returned.  Metrics: loss, ce, tokens,
    load_balance, router_z, grad_norm, lr (0-dim tensors, whole on every
    rank)."""
    n = num_microbatches
    if accum_dtype is None:
        accum_dtype = "bfloat16" if getattr(cfg, "fsdp", False) else "float32"
    acc_dt = torch.bfloat16 if accum_dtype == "bfloat16" else torch.float32
    memo: dict = {}  # the parameters' placements: they depend on shapes and the plan only

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = state.params
        batch = _on(batch, params["embed"].device)
        leaves = cast_leaves(params, cfg)
        if not memo:
            sh = param_shardings_of(params, plan)
            memo.update(shardings=sh, pin={} if sh is None else {"shardings": reference_leaves(sh, cfg.period)})
        shardings = memo["shardings"]
        if n == 1:
            loss, metrics, grads = value_and_grad(cfg, leaves, place_batch(batch, plan), attn_chunk=attn_chunk,
                                                  plan=plan)
            grads = constrain_like_params(grads, shardings)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % n:
                raise ValueError(f"batch {B} is not divisible by num_microbatches {n}")
            grads, loss = None, torch.zeros((), dtype=torch.float32, device=params["embed"].device)
            for i in range(n):
                mb = place_batch({k: _microbatch(v, n, i) for k, v in batch.items()}, plan)
                mb_loss, metrics, g = value_and_grad(cfg, leaves, mb, attn_chunk=attn_chunk, plan=plan)
                g = constrain_like_params(g, shardings)
                loss = loss + full(mb_loss)
                if grads is None:
                    grads = {k: x.to(acc_dt) for k, x in g.items()}
                else:
                    for k, x in g.items():
                        grads[k].add_(x.to(acc_dt))
                del g
            grads = {k: x.div_(n) for k, x in grads.items()}
            loss = loss / n
        del leaves
        grad_leaves = reference_leaves(grads, cfg.period)
        opt = state.opt
        if compress_grads:  # int8 + error feedback at the accumulation boundary
            grad_leaves, opt = compress_decompress(grad_leaves, opt)
        _, opt, opt_metrics = adamw_update(master_leaves(params, cfg), grad_leaves, opt, opt_cfg, **memo["pin"])
        state.opt = opt
        return state, {k: full(v) for k, v in dict(metrics, loss=loss, **opt_metrics).items()}

    return train_step
