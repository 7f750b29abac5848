"""Decomposition facade of the port.  Counterpart of `repro.api`:

    from repro_torch.api import decompose
    cp = decompose(st, rank=16)                        # CP-ALS on the CUDA MTTKRP kernel
    tk = decompose(st, (16, 16, 16), format="tucker")  # HOOI on the CUDA TTMc kernel
    cp = decompose(st, 4, device="cpu")                # the plain PyTorch path

`format="cp"` and `format="tucker"` are ported; tensor-train is a later
slice of the port (ROADMAP.md, queue 1, item 7).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .core.coo import SparseTensor
from .core.cp_als import CPState, cp_als
from .tucker.hooi import TuckerState, tucker_hooi

__all__ = ["decompose"]

_FORMATS = ("cp", "tucker", "tt")
_NOT_PORTED = {
    "tt": "ROADMAP.md queue 1 item 7 (TT-ALS)",
}


def decompose(
    st: SparseTensor,
    rank: int | Sequence[int],
    *,
    format: str = "cp",
    iters: int = 10,
    seed: int = 0,
    tol: float | None = None,
    init_factors: Sequence | None = None,
    planned=None,
    device: str | torch.device | None = None,
    verbose: bool = False,
) -> CPState | TuckerState:
    """Decompose a sparse tensor on the planned memory-controller kernels.

    Args:
      st: host-side COO tensor (>= 3 modes, at most 5).
      rank: the CP rank (int), or the Tucker core ranks (N-tuple; an int
        broadcasts to every mode).
      format: 'cp' (CP-ALS) or 'tucker' (HOOI).  'tt' raises
        NotImplementedError until its slice is ported.
      iters / seed / tol / verbose: iteration count, init seed, host-side
        fit-change early exit, per-iteration fit printing.
      init_factors: initial factors, one (I_m, R_m) array per mode (Tucker's
        orthonormal); without them a torch generator seeded with `seed`
        draws them (not the reference's numbers — see `cp_als` and
        `tucker_hooi`).
      planned: a prebuilt `PlannedCPALS` or `PlannedTucker` whose plans are
        reused.
      device: CUDA unless given; raises when no GPU is present and no device
        was given.

    Returns:
      `CPState(factors, lam, fit_history)` or
      `TuckerState(factors, core, fit_history)`.
    """
    if format not in _FORMATS:
        raise ValueError(f"unknown format {format!r}: expected 'cp', 'tucker' or 'tt'")
    if format in _NOT_PORTED:
        raise NotImplementedError(
            f"format={format!r} is not ported to PyTorch yet: see {_NOT_PORTED[format]}")
    if format == "tucker":
        ranks = (rank,) * st.nmodes if isinstance(rank, int) else tuple(int(r) for r in rank)
        return tucker_hooi(st, ranks, iters=iters, tol=tol, init_factors=init_factors,
                           seed=seed, device=device, planned=planned, verbose=verbose)
    if not isinstance(rank, int):
        raise ValueError(f"format='cp' takes a single integer rank, got {rank!r}")
    return cp_als(st, rank, iters=iters, tol=tol, init_factors=init_factors, seed=seed,
                  device=device, planned=planned, verbose=verbose)
