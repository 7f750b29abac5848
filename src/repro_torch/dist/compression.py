"""Gradient compression: int8 quantization with error feedback.  The port of
`repro.dist.compression`.

Applied at the microbatch-accumulation boundary (train/train_step.py): each
leaf of the accumulated gradient tree is quantized to int8 with one float32
scale, dequantized, and the float32 residual is carried in the optimizer
state under ``"ef"``, so the quantization bias averages out over steps
(1-bit-Adam-style error feedback; Seide et al. 2014).

Trees are the train step's (`train/stacks.py`): dicts from the reference's
leaf names to a tensor or a stack of per-layer tensors.  A stack takes one
scale, the max over its layers, as the reference's stacked leaf does.  The
residual is updated in place.
"""
from __future__ import annotations

import torch

from ..train.stacks import map_tree, members

__all__ = ["quantize_int8", "dequantize_int8", "compress_decompress", "init_error_feedback"]

_EF_KEY = "ef"


def _zeros_f32(t: torch.Tensor) -> torch.Tensor:
    """float32 zeros like `t` (a DTensor's keep its placements)."""
    return torch.zeros_like(t, dtype=torch.float32)


def init_error_feedback(opt_state: dict, params: dict) -> dict:
    """Pre-seed the zeroed residual tree so the opt-state structure is stable
    from step 0 (checkpoint/restore see the same tree from the start)."""
    return {**opt_state, _EF_KEY: map_tree(_zeros_f32, params)}


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax / 127.0, min=1e-30)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q int8, scale f32)
    with q = round(x / scale) (half to even), scale = max|x| / 127 floored
    at 1e-30, so the reconstruction error is at most scale/2 per element."""
    xf = x.float()
    scale = _scale(xf.abs().max())
    return _quantize(xf, scale), scale


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(grads: dict, opt_state: dict) -> tuple[dict, dict]:
    """Quantize->dequantize the gradient tree with error feedback.

    The float32 residual tree lives under ``"ef"`` in `opt_state` (created
    zeroed on first use) and is updated in place.  Returns the dequantized
    gradients (in each gradient's dtype) and the state dict."""
    err = opt_state.get(_EF_KEY)
    if err is None:
        err = map_tree(_zeros_f32, grads)
    deq_tree = {}
    for key, leaf in grads.items():
        gs, es = members(leaf), members(err[key])
        # one scale for the whole leaf; x = g + e is formed again per layer
        # below, so no float32 copy of a whole stack is held at once
        amax = torch.stack([(g.float() + e).abs().max() for g, e in zip(gs, es)]).max()
        scale = _scale(amax)
        out = []
        for g, e in zip(gs, es):
            x = g.float() + e
            deq = dequantize_int8(_quantize(x, scale), scale)
            e.copy_(x.sub_(deq))
            out.append(deq.to(g.dtype))
        deq_tree[key] = out if isinstance(leaf, list) else out[0]
    return deq_tree, {**opt_state, _EF_KEY: err}
