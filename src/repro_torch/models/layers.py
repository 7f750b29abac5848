"""Primitive layers shared by every architecture: norms, projections,
embeddings, RoPE, MLPs.  The port of `repro.models.layers`.

Conventions (used by every model module of the port):
  * Parameters live in `Params` modules under the reference's leaf names
    (`wq`, `wg`, `scale`, ...); `p["wq"]` and `"bq" in p` read them as the
    reference reads its dicts.  Every leaf is drawn from an explicit
    `torch.Generator` on an explicit device; on the `meta` device nothing is
    drawn, which gives the abstract parameter tree.
  * Compute dtype (bfloat16 on the card) is applied at use; parameters stay
    in param_dtype.
  * Functions are plain: tensors and `Params` in, tensors out.  The
    `Params` leaves need no gradient (serving runs under `torch.no_grad`);
    the train step takes gradients against a tree of plain dicts holding
    cast copies of them (`train/train_step.py`), which every function here
    reads as it reads `Params`.
  * On a mesh the tensors are DTensors; a table built here from shapes
    alone (RoPE frequencies, sinusoid dims) is made a replicated DTensor
    beside them (`dist.sharding.replicated`), since DTensor ops refuse
    plain tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dist.sharding import replicated

__all__ = ["Params", "tree_of", "dtype_of", "dense_init", "embed_init", "rmsnorm_init", "rmsnorm",
           "layernorm_init", "layernorm", "norm_init", "norm_apply", "linear_init", "linear",
           "embed", "rope_angles", "apply_rope", "sinusoid_positions", "sinusoid_rows", "GLU_ACTS",
           "is_glu", "gelu", "mlp_init", "mlp"]


class Params(nn.Module):
    """One node of a parameter tree: tensors (registered as parameters that
    need no gradient) and child nodes, under the reference's names."""

    def __init__(self, **leaves):
        super().__init__()
        for name, leaf in leaves.items():
            if isinstance(leaf, nn.Module):
                self.add_module(name, leaf)
            else:
                self.register_parameter(name, nn.Parameter(leaf, requires_grad=False))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def __getitem__(self, name: str):
        return getattr(self, name)


def tree_of(named: dict):
    """Tensors by dotted name as the nested tree the model functions read:
    dicts, and lists where every key is a layer index."""
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


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _drawn(shape, device, draw) -> torch.Tensor:
    """A float32 tensor of `shape` on `device`, filled in place by `draw`
    (nothing is drawn on the `meta` device)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        draw(t)
    return t


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator, device, dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (LLM standard): a standard normal cut to
    [-2, 2], times 1/sqrt(d_in) unless `scale` is given."""
    s = scale if scale is not None else 1.0 / np.sqrt(d_in)

    def draw(t):
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(s)

    return _drawn((d_in, d_out), device, draw).to(dtype)


def embed_init(vocab: int, d: int, *, generator: torch.Generator, device, dtype=torch.float32) -> torch.Tensor:
    def draw(t):
        t.normal_(generator=generator).mul_(0.02)

    return _drawn((vocab, d), device, draw).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, *, device, dtype=torch.float32) -> Params:
    return Params(scale=torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm_init(d: int, *, device, dtype=torch.float32) -> Params:
    return Params(scale=torch.ones((d,), dtype=dtype, device=device),
                  bias=torch.zeros((d,), dtype=dtype, device=device))


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def norm_init(kind: str, d: int, *, device, dtype=torch.float32) -> Params:
    return rmsnorm_init(d, device=device, dtype=dtype) if kind == "rms" else \
        layernorm_init(d, device=device, dtype=dtype)


def norm_apply(kind: str, p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return rmsnorm(p, x, eps) if kind == "rms" else layernorm(p, x, eps)


# ---------------------------------------------------------------------------
# linear / embedding
# ---------------------------------------------------------------------------


def linear_init(d_in: int, d_out: int, *, generator: torch.Generator, device, bias: bool = False,
                dtype=torch.float32) -> Params:
    leaves = {"w": dense_init(d_in, d_out, generator=generator, device=device, dtype=dtype)}
    if bias:
        leaves["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return Params(**leaves)


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embed(table: torch.Tensor, ids: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Token embedding gather — the dense-arch instance of the paper's
    Cache-Engine access pattern (random row fetch with power-law reuse)."""
    return table[ids].to(compute_dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos..., hd/2) cos/sin tables, fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * replicated(freqs, positions)  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, hd); cos/sin: (..., seq, hd/2) broadcast over heads.
    Rotate-half convention (llama/qwen)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoid_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Classic sinusoidal position table (whisper adaptation), (seq, d) f32."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * dim / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.tensor(out, dtype=torch.float32, device=device)


def sinusoid_rows(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Rows `pos` (any int shape) of `sinusoid_positions(n, d)`, computed on
    `pos`'s device in float64 as the table is: the same float32 numbers
    without building the table."""
    dim = replicated(torch.arange(d // 2, dtype=torch.float64, device=pos.device), pos)
    ang = pos.double()[..., None] / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default: the tanh approximation, not the exact erf."""
    return F.gelu(x, approximate="tanh")


GLU_ACTS = {"silu": F.silu, "gelu_glu": gelu}  # 3-matrix gated MLPs


def is_glu(act: str) -> bool:
    return act in GLU_ACTS


def mlp_init(d: int, d_ff: int, act: str, *, generator: torch.Generator, device,
             dtype=torch.float32) -> Params:
    def dense(d_in, d_out):
        return dense_init(d_in, d_out, generator=generator, device=device, dtype=dtype)

    if is_glu(act):  # gated: gate, up, down (SwiGLU / GeGLU)
        return Params(wg=dense(d, d_ff), wu=dense(d, d_ff), wd=dense(d_ff, d))
    return Params(  # classic 2-matrix GELU MLP
        wu=dense(d, d_ff), wd=dense(d_ff, d),
        bu=torch.zeros((d_ff,), dtype=dtype, device=device),
        bd=torch.zeros((d,), dtype=dtype, device=device))


def mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    """Every act that is not gated (whisper's "gelu", minitron's "relu2")
    takes the 2-matrix GELU path, as in the reference."""
    if is_glu(act):
        g = GLU_ACTS[act](x @ p["wg"].to(x.dtype))
        u = x @ p["wu"].to(x.dtype)
        return (g * u) @ p["wd"].to(x.dtype)
    h = gelu(x @ p["wu"].to(x.dtype) + p["bu"].to(x.dtype))
    return h @ p["wd"].to(x.dtype) + p["bd"].to(x.dtype)
