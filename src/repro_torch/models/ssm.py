"""Mamba2 / SSD (state-space duality) blocks — arXiv:2405.21060.  The port
of `repro.models.ssm`.

Three execution paths over the same parameters:
  * ``ssd_chunked``   — production path: chunked matmul form (intra-chunk
                        attention-like matmuls + an inter-chunk loop over
                        per-chunk states).  O(S·Q) score work + O(S/Q)
                        state hops.
  * ``ssd_reference`` — naive per-token recurrence (a loop over S); the
                        oracle the chunked path is tested against.
  * ``ssd_decode_step`` — one-token state update for serving.

Layout: x (B, S, H, P) heads x head_dim; B/C (B, S, G, N) groups x state;
dt (B, S, H).  State h is (B, H, P, N), fp32 throughout the recurrence.
The segment sums are the reference's: a cumulative sum of log decays per
chunk and exp of their differences, taken below the diagonal only (the
reference also exponentiates the masked deltas above it, which overflow
at full width and turn its gradients NaN; the values are the same).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Params, dense_init, rmsnorm

__all__ = ["ssd_reference", "ssd_chunked", "ssd_decode_step", "mamba_init", "mamba_train", "mamba_decode",
           "mamba_init_cache", "causal_conv1d", "conv1d_decode_step"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) without a cut-over (`jax.nn.softplus`)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _expand_groups(bc: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N): broadcast each group over its heads."""
    G = bc.shape[2]
    return torch.repeat_interleave(bc, H // G, dim=2)


def ssd_reference(x, dt, A, Bm, Cm, D=None, h0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T;
    y_t = C_t h_t (+ D x_t).  x (B, S, H, P), dt (B, S, H) post-softplus,
    A (H,) negative, Bm/Cm (B, S, G, N), D (H,), h0 (B, H, P, N).
    Returns (y (B,S,H,P), h_final)."""
    Bsz, S, H, P = x.shape
    Bh = _expand_groups(Bm, H).float()
    Ch = _expand_groups(Cm, H).float()
    xf = x.float()
    dtf = dt.float()
    a = torch.exp(dtf * A[None, None, :])  # (B, S, H)
    h = (torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = a[:, t, :, None, None] * h + torch.einsum("bhp,bhn->bhpn", dtf[:, t, :, None] * xf[:, t], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, H, P))
    if D is not None:
        y = y + xf * D[None, None, :, None]
    return y.to(x.dtype), h


def ssd_chunked(x, dt, A, Bm, Cm, D=None, h0=None, *, chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba2 Alg. 1 structure).  Per chunk of length Q:

      intra:  Y1[t] = sum_{s<=t} (C_t.B_s) dt_s exp(l_t - l_s) x_s      (matmuls)
      state:  S_c   = sum_s exp(l_Q - l_s) dt_s x_s (x) B_s             (matmul)
      inter:  H_c   = exp(l_Q) H_{c-1} + S_c                            (loop)
              Y2[t] = C_t . (exp(l_t) H_{c-1})

    All recurrences are over S/Q chunk states only.  fp32 internally.  A
    ragged tail is padded with dt = 0 steps (decay 1, contribution 0)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:  # pad tail with dt=0 steps: a=exp(0)=1, contribution 0 — the
        pad = Q - S % Q  # state is untouched and padded outputs are discarded.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        y, h = ssd_chunked(x, dt, A, Bm, Cm, D, h0, chunk=Q)
        return y[:, :S], h
    nc = S // Q

    xf = x.float().reshape(Bsz, nc, Q, H, P)
    dtf = dt.float().reshape(Bsz, nc, Q, H)
    Bh = _expand_groups(Bm, H).float().reshape(Bsz, nc, Q, H, N)
    Ch = _expand_groups(Cm, H).float().reshape(Bsz, nc, Q, H, N)

    loga = dtf * A[None, None, None, :]  # (B, nc, Q, H) log decay per step
    l = torch.cumsum(loga, dim=2)  # inclusive cumulative log decay
    ltot = l[:, :, -1]  # (B, nc, H) chunk total

    # --- intra-chunk (attention-like, lower-triangular) ---
    # M[t,s] = (C_t . B_s) * dt_s * exp(l_t - l_s), s <= t
    cb = torch.einsum("bcqhn,bcshn->bchqs", Ch, Bh)  # (B, nc, H, Q, Q)
    lt = l.permute(0, 1, 3, 2)  # (B, nc, H, Q)
    delta = lt[..., :, None] - lt[..., None, :]  # l_t - l_s
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # exp of the masked deltas only: above the diagonal delta > 0 can
    # overflow to inf, whose 0-weighted gradient would be NaN (inf * 0)
    zero = torch.zeros((), device=x.device)
    seg = torch.where(tri, torch.exp(torch.where(tri, delta, zero)), zero)
    M = cb * seg * dtf.permute(0, 1, 3, 2)[..., None, :]  # * dt_s
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", M, xf)

    # --- per-chunk states ---
    # S_c = sum_s exp(ltot - l_s) dt_s x_s (x) B_s   -> (B, nc, H, P, N)
    w = torch.exp(ltot[:, :, None, :] - l) * dtf  # (B, nc, Q, H)
    Sc = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", w, xf, Bh)

    # --- inter-chunk loop over nc states ---
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device) if h0 is None else h0.float()
    h_enter = []
    for c in range(nc):
        h_enter.append(h)  # state *entering* this chunk
        h = torch.exp(ltot[:, c])[..., None, None] * h + Sc[:, c]
    h_enter = torch.stack(h_enter, dim=1)  # (B, nc, H, P, N) state before chunk

    # --- inter-chunk contribution ---
    # Y2[t] = exp(l_t) * C_t . H_enter
    y_inter = torch.exp(l)[..., None] * torch.einsum("bcqhn,bchpn->bcqhp", Ch, h_enter)

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    if D is not None:
        y = y + x.float() * D[None, None, :, None]
    return y.to(x.dtype), h


def ssd_decode_step(h, x, dt, A, Bm, Cm, D=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update: h (B, H, P, N) fp32, x (B, H, P), dt (B, H)
    post-softplus, Bm/Cm (B, G, N).  Returns (y (B,H,P), h_new)."""
    H = x.shape[1]
    G = Bm.shape[1]
    Bh = torch.repeat_interleave(Bm, H // G, dim=1).float()
    Ch = torch.repeat_interleave(Cm, H // G, dim=1).float()
    xf = x.float()
    dtf = dt.float()
    a = torch.exp(dtf * A[None, :])  # (B, H)
    h = a[..., None, None] * h + torch.einsum("bhp,bhn->bhpn", dtf[..., None] * xf, Bh)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)
    if D is not None:
        y = y + xf * D[None, :, None]
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# causal depthwise conv1d (the Mamba front conv)
# ---------------------------------------------------------------------------


def causal_conv1d(x, w, b, state=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, C), w (K, C), b (C).  Left-pad with `state` (B, K-1, C) (zeros
    if None).  Returns (y (B,S,C) silu-activated, new_state = last K-1 inputs)."""
    Bsz, S, C = x.shape
    K = w.shape[0]
    pad = x.new_zeros((Bsz, K - 1, C)) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    y = torch.zeros((Bsz, S, C), dtype=torch.float32, device=x.device)
    for k in range(K):
        y = y + xp[:, k:k + S].float() * w[k].float()
    y = F.silu(y + b.float())
    new_state = xp[:, S:]  # last K-1 raw inputs
    return y.to(x.dtype), new_state


def conv1d_decode_step(x, w, b, state) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, C) one token; state (B, K-1, C). Returns (y (B,C), new_state)."""
    window = torch.cat([state.to(x.dtype), x[:, None]], dim=1)  # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window.float(), w.float())
    y = F.silu(y + b.float())
    return y.to(x.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------


def mamba_init(d: int, ssm_cfg, *, generator: torch.Generator, device, dtype=torch.float32) -> Params:
    """Mamba2 block parameters.  in_proj fans out to
    [z (d_in) | x (d_in) | B (G*N) | C (G*N) | dt (H)]; conv runs over
    [x | B | C]; gated RMSNorm before out_proj (Mamba2 convention)."""
    s = ssm_cfg
    d_in = s.expand * d
    H = d_in // s.head_dim
    G, N = s.n_groups, s.d_state
    conv_dim = d_in + 2 * G * N
    in_proj = dense_init(d, 2 * d_in + 2 * G * N + H, generator=generator, device=device, dtype=dtype)
    conv_w = torch.empty((s.d_conv, conv_dim), dtype=torch.float32, device=device)
    dt_bias = torch.empty((H,), dtype=torch.float32, device=device)
    if conv_w.device.type != "meta":
        conv_w.normal_(generator=generator).mul_(1.0 / math.sqrt(s.d_conv * 1.0))
        dt = torch.exp(dt_bias.uniform_(math.log(1e-3), math.log(1e-1), generator=generator))
        dt_bias = torch.log(torch.expm1(dt))
    return Params(
        in_proj=in_proj,
        conv_w=conv_w.to(dtype),
        conv_b=torch.zeros((conv_dim,), dtype=dtype, device=device),
        A_log=torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=device)),  # A = -exp(A_log)
        D=torch.ones((H,), dtype=torch.float32, device=device),
        dt_bias=dt_bias,
        out_norm=Params(scale=torch.ones((d_in,), dtype=dtype, device=device)),
        out_proj=dense_init(d_in, d, generator=generator, device=device, dtype=dtype),
    )


def _mamba_split(xz: torch.Tensor, d_in: int, G: int, N: int):
    z, rest = xz[..., :d_in], xz[..., d_in:]
    xbc = rest[..., :d_in + 2 * G * N]
    dt_raw = rest[..., d_in + 2 * G * N:]  # (..., H)
    return z, xbc, dt_raw


def mamba_train(p: Params, x: torch.Tensor, cfg, h0=None, conv0=None, *, return_state: bool = False):
    """Full-sequence Mamba2 block.  x (B, S, D) -> (B, S, D).
    With return_state=True also returns (h_final, conv_state) for prefill."""
    s = cfg.ssm
    d = x.shape[-1]
    d_in = s.expand * d
    H = d_in // s.head_dim
    G, N = s.n_groups, s.d_state
    Bsz, S, _ = x.shape

    xz = x @ p["in_proj"].to(x.dtype)  # (B, S, 2*d_in + 2GN + H)
    z, xbc, dt_raw = _mamba_split(xz, d_in, G, N)
    xbc, conv_state = causal_conv1d(xbc, p["conv_w"], p["conv_b"], conv0)
    xs = xbc[..., :d_in].reshape(Bsz, S, H, s.head_dim)
    Bm = xbc[..., d_in:d_in + G * N].reshape(Bsz, S, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(Bsz, S, G, N)
    dt = softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    y, h = ssd_chunked(xs, dt, A, Bm, Cm, p["D"], h0, chunk=s.chunk)
    y = y.reshape(Bsz, S, d_in)
    y = rmsnorm(p["out_norm"], y * F.silu(z))  # gated norm
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, (h, conv_state)
    return out


def mamba_init_cache(batch: int, d: int, ssm_cfg, dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    s = ssm_cfg
    d_in = s.expand * d
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {
        "h": torch.zeros((batch, H, s.head_dim, s.d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def mamba_decode(p: Params, x: torch.Tensor, cache: dict[str, torch.Tensor], cfg):
    """One-token Mamba2 step.  x (B, 1, D) -> (B, 1, D), updated cache."""
    s = cfg.ssm
    d = x.shape[-1]
    d_in = s.expand * d
    H = d_in // s.head_dim
    G, N = s.n_groups, s.d_state
    Bsz = x.shape[0]

    xz = x[:, 0] @ p["in_proj"].to(x.dtype)  # (B, ...)
    z, xbc, dt_raw = _mamba_split(xz, d_in, G, N)
    xbc, conv_state = conv1d_decode_step(xbc, p["conv_w"], p["conv_b"], cache["conv"])
    xs = xbc[..., :d_in].reshape(Bsz, H, s.head_dim)
    Bm = xbc[..., d_in:d_in + G * N].reshape(Bsz, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(Bsz, G, N)
    dt = softplus(dt_raw.float() + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    y, h = ssd_decode_step(cache["h"], xs, dt, A, Bm, Cm, p["D"])
    y = y.reshape(Bsz, d_in)
    y = rmsnorm(p["out_norm"], y * F.silu(z))
    out = (y @ p["out_proj"].to(x.dtype))[:, None]
    return out, {"h": h, "conv": conv_state}
