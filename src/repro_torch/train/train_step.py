"""Microbatched training step on one device: the port of
`repro.train.train_step` (its single-device path, `plan = NOPLAN`).

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
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..dist.compression import compress_decompress, init_error_feedback
from ..models import transformer as T
from ..models.layers import Params, dtype_of
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .stacks import is_layer_leaf, reference_leaves

__all__ = ["TrainState", "init_train_state", "make_train_step", "master_leaves", "cast_leaves",
           "value_and_grad"]


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
                     compress_grads: bool = False) -> TrainState:
    """Parameters drawn from `generator` (default: seed 0 on `device`) on
    `device` (default CUDA; raises without a GPU unless a device is given),
    and a zeroed optimizer state (with compress_grads, a zeroed int8
    residual too)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    params = T.init_params(cfg, generator=generator, device=device)
    leaves = master_leaves(params, cfg)
    opt = adamw_init(leaves, opt_cfg)
    if compress_grads:  # the residual exists from step 0: a stable state structure
        opt = init_error_feedback(opt, leaves)
    return TrainState(params=params, opt=opt, rng=generator)


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


def _param_tree(named: dict[str, torch.Tensor]):
    """Tensors by dotted name as the nested tree the model reads: dicts, and
    lists where every key is a layer index."""
    root: dict = {}
    for name, t in named.items():
        node = root
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return fix(root)


def value_and_grad(cfg, leaves: dict[str, torch.Tensor], batch: dict, *, attn_chunk: int = 2048
                   ) -> tuple[torch.Tensor, dict, dict[str, torch.Tensor]]:
    """`apply_train` on the tree of `leaves` (tensors that require grad, by
    the port's names): (loss, metrics, gradients by name), all detached.
    A leaf the loss does not reach gets a zero gradient."""
    with torch.enable_grad():
        loss, metrics = T.apply_train(_param_tree(leaves), batch, cfg, attn_chunk=attn_chunk)
        ts = list(leaves.values())
        grads = torch.autograd.grad(loss, ts, allow_unused=True)
    grads = {name: torch.zeros_like(t) if g is None else g for (name, t), g in zip(leaves.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _on(batch: dict, device: torch.device) -> dict:
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: AdamWConfig, *, num_microbatches: int = 1, attn_chunk: int = 2048,
                    compress_grads: bool = False, accum_dtype: str | None = None) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``.  The batch
    (numpy arrays or tensors, leading dimension B divisible by
    num_microbatches) is moved to the parameters' device; the state is
    updated in place and returned.  Metrics: loss, ce, tokens,
    load_balance, router_z, grad_norm, lr (0-dim tensors)."""
    n = num_microbatches
    if accum_dtype is None:
        accum_dtype = "bfloat16" if getattr(cfg, "fsdp", False) else "float32"
    acc_dt = torch.bfloat16 if accum_dtype == "bfloat16" else torch.float32

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = state.params
        batch = _on(batch, params["embed"].device)
        leaves = cast_leaves(params, cfg)
        if n == 1:
            loss, metrics, grads = value_and_grad(cfg, leaves, batch, attn_chunk=attn_chunk)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % n:
                raise ValueError(f"batch {B} is not divisible by num_microbatches {n}")
            grads, loss = None, torch.zeros((), dtype=torch.float32, device=params["embed"].device)
            for i in range(n):
                mb = {k: v.reshape((n, B // n) + v.shape[1:])[i] for k, v in batch.items()}
                mb_loss, metrics, g = value_and_grad(cfg, leaves, mb, attn_chunk=attn_chunk)
                loss = loss + mb_loss
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
        _, opt, opt_metrics = adamw_update(master_leaves(params, cfg), grad_leaves, opt, opt_cfg)
        state.opt = opt
        return state, dict(metrics, loss=loss, **opt_metrics)

    return train_step
