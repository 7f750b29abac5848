"""AdamW, the port of `repro.train.optimizer` (no torch.optim: the same
state tree and the same float32 math as the reference, step for step).

  * ``state_dtype`` ("bfloat16" halves m/v memory); master math is float32.
  * Decoupled weight decay, global-norm clipping, linear-warmup cosine decay.
  * ``factored_v``: Adafactor-style factored second moment (row and column
    means of g^2) on leaves of rank 2 or more.

Trees are dicts from the reference's leaf names to a tensor or a stack of
per-layer tensors (`train/stacks.py`): a stack has the reference's rank,
one more than its layers', so weight decay and the factored moment reach
the same leaves as in the reference.  The update runs one tensor at a
time (a leaf, or one layer of a stack), and `adamw_update` writes the new
parameters and moments in place (the reference's train step donates them).

`sequential_updates` is accepted and has no effect: it orders the XLA
graph's leaf updates, which eager PyTorch already runs one after another.
`update_slices` walks the leading dimension of each updated tensor of 3 or
more dimensions and at least 2^28 elements in that many slices (the
reference's rule), bounding the float32 working set of an expert stack;
the result is bit for bit the unsliced one.

On a mesh the tensors are DTensors: `opt_pspecs` gives the moments' specs
(the parameters', and for a factored moment its row and column specs, as
the reference's), `shardings=` pins each gradient to its parameter's
placements first, and a tensor whose gradient and moments share its
layout is updated on each rank's own shards (the math is elementwise);
a factored moment's row and column means are DTensor reductions, each new
value written back at its tensor's own placements.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import operator

import torch

from ..dist.sharding import P, full, is_dtensor
from .stacks import Leaf, map_tree, members, rank

#: A parameter tree: the reference's leaf names to a tensor or a per-layer
#: stack (`train/stacks.py`).
Params = dict

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "opt_pspecs", "lr_at", "global_norm"]

#: The smallest tensor `update_slices` slices (the reference's 2^28).
SLICE_MIN_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"  # 'bfloat16' halves m/v memory
    sequential_updates: bool = True  # accepted; no effect in eager PyTorch
    update_slices: int = 1  # >1: slice huge (>= 2^28 elements) tensors' updates
    factored_v: bool = False  # Adafactor-style factored second moment


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac (float32 math)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def _factored_v(p: torch.Tensor) -> dict:
    return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),  # rowwise E[g^2]
            "c": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device)}


def _small_stack(leaf: Leaf) -> bool:
    """A stack of vectors or scalars: updated stacked (its factored moment
    couples the layers)."""
    return isinstance(leaf, list) and leaf[0].dim() <= 1


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    """{"m", "v", "step"}: m and v mirror `params` (stacks as lists); with
    factored_v a leaf of rank 2 or more gets {"r", "c"} float32 in place of
    v (per layer for a stack of matrices, one pair for a stack of
    vectors)."""
    dt = _state_dtype(cfg)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    def v_init(leaf):
        if not (cfg.factored_v and rank(leaf) >= 2):
            return [zeros(p) for p in leaf] if isinstance(leaf, list) else zeros(leaf)
        if _small_stack(leaf):  # one pair for the stack: r per layer, c shared
            first = leaf[0]
            return {"r": torch.zeros((len(leaf),) + first.shape[:-1], dtype=torch.float32, device=first.device),
                    "c": torch.zeros(first.shape[-1:], dtype=torch.float32, device=first.device)}
        return [_factored_v(p) for p in leaf] if isinstance(leaf, list) else _factored_v(leaf)

    device = members(next(iter(params.values())))[0].device if params else None
    return {"m": map_tree(zeros, params), "v": {k: v_init(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_pspecs(params: dict, p_specs: dict, cfg: AdamWConfig) -> dict:
    """The spec tree of `adamw_init`'s state, mirroring its structure: m and
    v take the parameters' specs (`p_specs`, a tree of the reference's leaf
    names like `params`, a stack a list of per-layer specs); a factored v
    takes {"r": the spec without its last entry, "c": without its
    second-to-last}.  A stack of vectors keeps one factored pair, its r
    over the layers (that entry replicated), its c the layers' last
    entry."""

    def rc(spec, ndim: int) -> dict:
        e = list(spec) + [None] * (ndim - len(spec))
        return {"r": P(*e[:-1]), "c": P(*e[:-2], e[-1])}

    def v_spec(leaf, spec):
        if not (cfg.factored_v and rank(leaf) >= 2):
            return spec
        if _small_stack(leaf):
            layer = list(spec[0]) + [None] * (leaf[0].dim() - len(spec[0]))
            return {"r": P(None, *layer[:-1]), "c": P(layer[-1])}
        if isinstance(leaf, list):
            return [rc(s, t.dim()) for s, t in zip(spec, leaf)]
        return rc(spec, leaf.dim())

    return {"m": p_specs, "v": {k: v_spec(params[k], p_specs[k]) for k in params}, "step": P()}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32.  Added
    left to right from the first term (`_total`): DTensor partial sums stay
    partial until the square root, one reduction in all."""
    sums = [_total(torch.sum(torch.square(t.float())) for t in members(leaf)) for leaf in tree.values()]
    return torch.sqrt(_total(sums))


def _total(terms) -> torch.Tensor:
    """((a + b) + c) + ...: Python's `sum` without its leading 0 (an int
    plus a partial sum would reduce it)."""
    return functools.reduce(operator.add, terms)


class _Step:
    """The step's scalars (float32 tensors, as the reference's)."""

    def __init__(self, cfg: AdamWConfig, step: torch.Tensor, gnorm: torch.Tensor):
        self.cfg = cfg
        self.scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        self.lr = lr_at(cfg, step)
        s = step.float()
        self.c1 = 1.0 - torch.pow(cfg.b1, s)
        self.c2 = 1.0 - torch.pow(cfg.b2, s)

    def math(self, p, g, m, v, decay: bool):
        """One tensor's update: (new p, new m, new v) in p's, m's and v's
        dtypes (factored r/c stay float32)."""
        cfg = self.cfg
        b1, b2 = cfg.b1, cfg.b2
        g = g.float() * self.scale
        mf = b1 * m.float() + (1 - b1) * g
        if isinstance(v, dict):  # factored second moment (Adafactor RC^T)
            # row/col means as contractions of g with itself (no g^2 tensor)
            r = b2 * v["r"] + (1 - b2) * torch.einsum("...ij,...ij->...i", g, g) / g.shape[-1]
            c = b2 * v["c"] + (1 - b2) * torch.einsum("...ij,...ij->...j", g, g) / g.shape[-2]
            denom = torch.clamp(torch.mean(r, dim=-1, keepdim=True), min=1e-30)
            vf = (r / denom)[..., None] * c[..., None, :]
            new_v = {"r": r, "c": c}
        else:
            vf = b2 * v.float() + (1 - b2) * g * g
            new_v = vf.to(v.dtype)
        upd = (mf / self.c1) / (torch.sqrt(vf / self.c2) + cfg.eps)
        if decay:  # decoupled weight decay on leaves of rank 2 or more
            upd = upd + cfg.weight_decay * p.float()
        newp = p.float() - self.lr * upd
        return newp.to(p.dtype), mf.to(m.dtype), new_v

    def on_local(self) -> "_Step":
        """This step with its scalars whole on each rank, for updating local
        shards (made once)."""
        if getattr(self, "_local", None) is None:
            out = object.__new__(_Step)
            out.cfg, out._local = self.cfg, None
            out.scale, out.lr, out.c1, out.c2 = (full(x) for x in (self.scale, self.lr, self.c1, self.c2))
            self._local = out
        return self._local

    def apply(self, p, g, m, v, decay: bool) -> None:
        """Update one tensor in place, in slices where update_slices asks.
        DTensors of one layout (an unfactored moment) update elementwise on
        each rank's own shards."""
        if is_dtensor(p) and not isinstance(v, dict) and \
                len({(x.device_mesh, tuple(x.placements)) for x in (p, g, m, v)}) == 1:
            self.on_local().apply(p.to_local(), g.to_local(), m.to_local(), v.to_local(), decay)
            return
        n = self.cfg.update_slices
        if n > 1 and p.dim() >= 3 and p.shape[0] % n == 0 and p.numel() >= SLICE_MIN_ELEMENTS:
            k = p.shape[0] // n
            for i in range(n):
                sl = slice(i * k, (i + 1) * k)
                vi = {key: x[sl] for key, x in v.items()} if isinstance(v, dict) else v[sl]
                self._write(self.math(p[sl], g[sl], m[sl], vi, decay), p[sl], m[sl], vi)
        else:
            self._write(self.math(p, g, m, v, decay), p, m, v)

    @staticmethod
    def _write(new, p, m, v) -> None:
        np_, nm, nv = new
        _copy(p, np_)
        _copy(m, nm)
        if isinstance(v, dict):
            _copy(v["r"], nv["r"])
            _copy(v["c"], nv["c"])
        else:
            _copy(v, nv)


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst.copy_(src), a DTensor's new value brought to dst's placements
    first (it keeps its sharding)."""
    if is_dtensor(dst) and tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                 shardings: dict | None = None) -> tuple[dict, dict, dict]:
    """One AdamW step.  Writes the new parameters and moments into `params`
    and `state` and returns (params, new state, metrics {grad_norm, lr}).
    Keys of `state` other than m, v and step (the compression residual
    "ef") are kept.  `shardings`: on a mesh, a tree like `grads` of DTensor
    placements, to which each gradient is redistributed first (the
    reference's re-pinning of the update chain)."""
    if shardings is not None:
        grads = {k: [g.redistribute(g.device_mesh, s) for g, s in zip(members(leaf), members(shardings[k]))]
                 if isinstance(leaf, list) else leaf.redistribute(leaf.device_mesh, shardings[k])
                 for k, leaf in grads.items()}
    step = state["step"] + 1
    gnorm = global_norm(grads)
    st = _Step(cfg, step, gnorm)
    for key, leaf in params.items():
        g, m, v = grads[key], state["m"][key], state["v"][key]
        decay = rank(leaf) >= 2
        if _small_stack(leaf):
            # stacked, as the reference holds it: a factored moment's row
            # mean couples the layers
            vs = v if isinstance(v, dict) else torch.stack(v)
            P, M = torch.stack(leaf), torch.stack(m)
            st.apply(P, torch.stack(g), M, vs, decay)
            for i, t in enumerate(leaf):
                t.copy_(P[i])
                m[i].copy_(M[i])
                if not isinstance(v, dict):
                    v[i].copy_(vs[i])
        else:
            for p_, g_, m_, v_ in zip(members(leaf), members(g), members(m),
                                       v if isinstance(leaf, list) else [v]):
                st.apply(p_, g_, m_, v_, decay)
    return params, {**state, "step": step}, {"grad_norm": gnorm, "lr": st.lr}
