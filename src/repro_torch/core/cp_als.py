"""CP-ALS driver (paper Alg. 1) on the planned MTTKRP kernel.

Counterpart of `repro.core.cp_als` for its main path, `method="pallas"`:
one BlockPlan per output mode is built once (`kernels.ops.PlannedCPALS`)
and every iteration runs, for each mode, the MTTKRP kernel -> gram ->
Cholesky solve -> normalize, then the fit.  PyTorch runs eagerly, so the
sweep is a plain Python loop over modes where the reference jits it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..device import resolve_device
from .coo import SparseTensor, norm_sq, to_device
from .loop import check_workspace, given_factors

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
    tol: float | None = None,
    init_factors: Sequence | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
    planned=None,
    auto_tune: bool | str = False,
    spec="default",
    cfg=None,
    verbose: bool = False,
) -> CPState:
    """Run CP-ALS on the planned MTTKRP kernel.

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
    """
    from ..kernels.ops import PlannedCPALS, make_planned_cp_als  # kernels build on core

    device = resolve_device(device)
    factors = _initial_factors(st, rank, init_factors, seed, device)
    if planned is None:
        planned = make_planned_cp_als(st, rank, cfg=cfg, auto_tune=auto_tune, spec=spec,
                                      device=device)
    else:
        check_workspace(planned, PlannedCPALS, {"shape": st.shape, "rank": rank}, device)
    idx, val = to_device(st, device)
    norm_x_sq = torch.tensor(norm_sq(st), dtype=torch.float32, device=device)
    factors, lam, fits = planned.drive(
        factors, (idx, val, norm_x_sq), iters=iters, tol=tol, verbose=verbose, label="cp_als")
    return CPState(factors=factors, lam=lam, fit_history=fits)
