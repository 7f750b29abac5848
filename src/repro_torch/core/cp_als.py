"""CP-ALS driver (paper Alg. 1).  Counterpart of `repro.core.cp_als`.

Every iteration runs, for each mode, an MTTKRP -> gram -> Cholesky solve ->
normalize, then the fit.  The MTTKRP comes from one of:
  * `method="pallas"` (the default, the main path): the planned MTTKRP
    kernel on one BlockPlan per output mode, built once
    (`kernels.ops.PlannedCPALS`);
  * `method="approach1"` / `"approach2"`: the paper's compute patterns
    (`core.mttkrp`) on the raw stream, laid out by `layout="remap"` (one
    stream, re-sorted by the Tensor Remapper before each mode,
    `_sweep_remap`) or `layout="copies"` (one sorted copy per mode,
    `_sweep_streams`);
  * `mttkrp_fn=`: any callable with the signature of `core.mttkrp.mttkrp`'s
    first five arguments, run in the same per-mode loop on the layout's
    streams (`PlannedCPALS.mttkrp_fn` is the planned kernel as such a
    callable).
PyTorch runs eagerly, so a sweep is a plain Python loop over modes where the
reference jits it; the port takes no `jit_sweep=`.  The reference's default
method is "approach1"; the port's is "pallas", the path its callers mean.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

from ..device import resolve_device
from .coo import SparseTensor, norm_sq, to_device
from .loop import (
    check_drive_extras,
    check_planned_method,
    check_workspace,
    finish_iter,
    given_factors,
)
from .mttkrp import mttkrp
from .remap import remap_stable

__all__ = [
    "CPState",
    "cp_als",
    "fit_value",
    "gram_hadamard",
    "inner_with_model",
    "model_norm_sq",
]

#: Non-zeros per step of the fit's inner product (bounds its gathers).
INNER_CHUNK = 1 << 22


@dataclasses.dataclass
class CPState:
    factors: list[torch.Tensor]  # one (I_m, R) per mode
    lam: torch.Tensor  # (R,) column norms
    fit_history: list[float]

    @property
    def rank(self) -> int:
        return int(self.lam.shape[0])


def gram_hadamard(factors: Sequence[torch.Tensor], mode: int) -> torch.Tensor:
    """Hadamard product of the Gram matrices F_n^T F_n for all n != mode. (R, R)."""
    g = None
    for n, f in enumerate(factors):
        if n == mode:
            continue
        gn = f.T @ f
        g = gn if g is None else g * gn
    if g is None:
        raise ValueError("need at least two modes")
    return g


def _solve(mttkrp_out: torch.Tensor, g: torch.Tensor, ridge: float = 1e-8) -> torch.Tensor:
    """A = M (G + ridge I)^-1 by Cholesky (G is symmetric positive
    semi-definite; the ridge keeps near rank-deficient iterations stable).
    `cholesky_ex` does not wait for the device to report a failed
    factorization: like the reference's solve, a failure shows as non-finite
    factors and a non-finite fit, which stops the drive loop."""
    r = g.shape[0]
    gi = g + ridge * torch.eye(r, dtype=g.dtype, device=g.device)
    chol, _ = torch.linalg.cholesky_ex(gi)
    return torch.cholesky_solve(mttkrp_out.T, chol).T


def _normalize(f: torch.Tensor, it: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Column-normalize.  The first iteration divides by max(norm, 1) (the
    initial random factors can carry tiny column norms); later iterations by
    the exact column 2-norm, guarded against 0."""
    norms = torch.linalg.vector_norm(f, dim=0)
    if it == 0:
        norms = torch.clamp(norms, min=1.0)
    else:
        norms = torch.where(norms > 1e-12, norms, torch.ones_like(norms))
    return f / norms, norms


def inner_with_model(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    lam: torch.Tensor,
    chunk: int = INNER_CHUNK,
) -> torch.Tensor:
    """<X, [[lam; factors]]> over X's non-zeros, taken in chunks of `chunk`
    non-zeros so the (chunk, R) gathers stay bounded at full tensor size."""
    total = torch.zeros((), dtype=lam.dtype, device=lam.device)
    for z0 in range(0, values.shape[0], chunk):
        idx = indices[z0: z0 + chunk]
        prod = None
        for n, f in enumerate(factors):
            rows = f.index_select(0, idx[:, n])
            prod = rows if prod is None else prod * rows
        total = total + torch.sum(values[z0: z0 + chunk] * (prod @ lam))
    return total


def model_norm_sq(factors: Sequence[torch.Tensor], lam: torch.Tensor) -> torch.Tensor:
    """||[[lam; factors]]||_F^2 = lam^T (hadamard_n F_n^T F_n) lam."""
    g = None
    for f in factors:
        gn = f.T @ f
        g = gn if g is None else g * gn
    return lam @ g @ lam


def fit_value(indices, values, factors, lam, norm_x_sq) -> torch.Tensor:
    """fit = 1 - ||X - X_hat|| / ||X||."""
    inner = inner_with_model(indices, values, factors, lam)
    resid_sq = torch.clamp(norm_x_sq + model_norm_sq(factors, lam) - 2.0 * inner, min=0.0)
    return 1.0 - torch.sqrt(resid_sq) / torch.sqrt(norm_x_sq)


def _update_mode(mt: torch.Tensor, factors: list, m: int, first: bool):
    """One Alg. 1 step: gram -> solve -> normalize."""
    g = gram_hadamard(factors, m)
    f = _solve(mt, g)
    f, lam = _normalize(f, 0 if first else 1)
    factors[m] = f
    return factors, lam


METHODS = ("pallas", "approach1", "approach2")
LAYOUTS = ("remap", "copies")


def _mode_mttkrp(method: str, mttkrp_fn: Callable | None) -> Callable:
    """The per-mode MTTKRP of a sweep: the caller's `mttkrp_fn`, else the
    compute pattern `method` on a stream sorted by the output mode."""
    if mttkrp_fn is not None:
        return mttkrp_fn
    return lambda idx, val, facs, m, rows: mttkrp(idx, val, facs, m, rows, method=method)


def _sweep_streams(factors, streams, norm_x_sq, *, shape, method: str, first: bool,
                   mttkrp_fn: Callable | None = None):
    """One ALS iteration over per-mode sorted streams (layout='copies'):
    every mode's MTTKRP on its own copy -> gram -> solve -> normalize, then
    the fit on the last copy.  `streams[m]` is the (indices, values) stream
    sorted by mode m.  Returns (factors, lam, fit)."""
    do_mttkrp = _mode_mttkrp(method, mttkrp_fn)
    factors = list(factors)
    lam = None
    for m in range(len(shape)):
        idx, val = streams[m]
        factors, lam = _update_mode(do_mttkrp(idx, val, factors, m, shape[m]), factors, m, first)
    idx, val = streams[-1]
    return factors, lam, fit_value(idx, val, factors, lam, norm_x_sq)


def _sweep_remap(factors, idx, val, norm_x_sq, *, shape, method: str, first: bool,
                 mttkrp_fn: Callable | None = None):
    """One ALS iteration on a single stream (layout='remap'): before each
    mode the Tensor Remapper re-sorts the carried stream by that mode on the
    device (Alg. 5), then MTTKRP -> gram -> solve -> normalize; the fit on
    the last order.  Returns (factors, lam, indices, values, fit), the
    stream sorted by the last mode, to be carried into the next sweep."""
    do_mttkrp = _mode_mttkrp(method, mttkrp_fn)
    factors = list(factors)
    lam = None
    for m in range(len(shape)):
        idx, val, _ = remap_stable(idx, val, m)
        factors, lam = _update_mode(do_mttkrp(idx, val, factors, m, shape[m]), factors, m, first)
    return factors, lam, idx, val, fit_value(idx, val, factors, lam, norm_x_sq)


def _initial_factors(st: SparseTensor, rank: int, init_factors, seed: int,
                     device: torch.device) -> list[torch.Tensor]:
    if init_factors is not None:
        return given_factors(init_factors, [(s, rank) for s in st.shape], device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return [
        torch.randn((s, rank), generator=gen, device=device) / math.sqrt(rank)
        for s in st.shape
    ]


def cp_als(
    st: SparseTensor,
    rank: int,
    *,
    iters: int = 10,
    method: str = "pallas",
    layout: str = "remap",
    tol: float | None = None,
    init_factors: Sequence | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
    mttkrp_fn: Callable | None = None,
    planned=None,
    auto_tune: bool | str = False,
    spec="default",
    cfg=None,
    verbose: bool = False,
    guards=None,
    checkpoint_every: int | None = None,
    checkpoint_path=None,
) -> CPState:
    """Run CP-ALS.

    method: 'pallas' (the default) - the planned MTTKRP kernel, one
      BlockPlan per output mode built once (`make_planned_cp_als`) and
      reused by every iteration; 'approach1' / 'approach2' - the paper's
      compute patterns (Sec. 3) on the raw stream on `device`.
    layout: for 'approach1' / 'approach2' and `mttkrp_fn`: 'remap' - one
      stream, sorted by mode 0 once and re-sorted on the device before each
      mode (Alg. 5); 'copies' - one sorted copy per mode (more device
      memory, no remap).  The planned path ignores it: its per-mode plans
      are the copies.
    mttkrp_fn: a callable (indices, values, factors, mode, out_rows) ->
      (I_mode, R) that replaces the method's MTTKRP, run in the per-mode
      loop on the layout's streams (e.g. `PlannedCPALS.mttkrp_fn`).
    init_factors: one (I_m, rank) array or tensor per mode.  Without it the
      factors are drawn as randn / sqrt(rank) from a
      `torch.Generator(device).manual_seed(seed)`; these numbers differ from
      the reference's `jax.random` draws for the same seed, so parity with
      the reference needs its factors passed in here.
    device: CUDA unless the caller passes one (raises if no GPU is present).
    planned: a prebuilt `PlannedCPALS` (`make_planned_cp_als`, which also
      takes the plan geometry) to reuse its plans across calls.
    auto_tune / spec / cfg: the workspace's plan geometry when `planned` is
      not given: `cfg` (a `MemoryControllerConfig`) for every mode, or the
      PMS's pick per mode for the MTTKRP kernel (auto_tune=True; "cached"
      keeps the winners on disk); `spec` is the PMS's `GPUSpec`,
      "default" or "measured".
    guards / checkpoint_every / checkpoint_path: the planned drive loop's
      resilience surface (`repro_torch.resilience`): a `GuardConfig` for
      divergence detection with raise/restart/fallback recovery, and
      checkpoints every k iterations with resume from a populated
      directory.  method='pallas' without `mttkrp_fn` only.
    """
    from ..kernels.ops import PlannedCPALS, make_planned_cp_als  # kernels build on core

    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}: expected 'remap' or 'copies'")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}: expected 'pallas', 'approach1' or 'approach2'")
    check_planned_method(method, planned)
    check_drive_extras(method, guards, checkpoint_every, checkpoint_path, mttkrp_fn=mttkrp_fn)
    if planned is not None and mttkrp_fn is not None:
        raise ValueError("mttkrp_fn replaces the planned kernel; the planned workspace would be "
                         "silently ignored (pass planned.mttkrp_fn as mttkrp_fn instead)")
    device = resolve_device(device)
    factors = _initial_factors(st, rank, init_factors, seed, device)
    norm_x_sq = torch.tensor(norm_sq(st), dtype=torch.float32, device=device)
    if method == "pallas" and mttkrp_fn is None:
        if planned is None:
            planned = make_planned_cp_als(st, rank, cfg=cfg, auto_tune=auto_tune, spec=spec,
                                          device=device)
        else:
            check_workspace(planned, PlannedCPALS, {"shape": st.shape, "rank": rank}, device)
        idx, val = to_device(st, device)
        factors, lam, fits = planned.drive(
            factors, (idx, val, norm_x_sq), iters=iters, tol=tol, verbose=verbose, label="cp_als",
            guards=guards, checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path)
        return CPState(factors=factors, lam=lam, fit_history=fits)

    idx, val = to_device(st, device)
    if layout == "copies":
        streams = [remap_stable(idx, val, m)[:2] for m in range(st.nmodes)]
        del idx, val
    else:  # one stream, sorted by the previous output mode
        idx, val, _ = remap_stable(idx, val, 0)
    fits: list[float] = []
    lam = None
    for it in range(iters):
        kw = dict(shape=st.shape, method=method, first=(it == 0), mttkrp_fn=mttkrp_fn)
        if layout == "copies":
            factors, lam, fit = _sweep_streams(factors, streams, norm_x_sq, **kw)
        else:
            factors, lam, idx, val, fit = _sweep_remap(factors, idx, val, norm_x_sq, **kw)
        if finish_iter(fits, fit, it, tol, verbose, "cp_als"):
            break
    return CPState(factors=factors, lam=lam, fit_history=fits)
