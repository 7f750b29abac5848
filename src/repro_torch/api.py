"""Decomposition facade of the port.  Counterpart of `repro.api`:

    from repro_torch.api import decompose
    cp = decompose(st, rank=16)                        # CP-ALS on the CUDA MTTKRP kernel
    tk = decompose(st, (16, 16, 16), format="tucker")  # HOOI on the CUDA TTMc kernel
    tt = decompose(st, (16, 16), format="tt")          # TT-ALS on the CUDA TT-core kernel
    cp = decompose(st, 4, device="cpu")                # the plain PyTorch path
    cp = decompose(st, 16, auto_tune=True)             # PMS-picked plan geometry per mode
    cp = decompose(st, 16, trace="cp.jsonl")           # spans of the call, exported as JSONL
    cp = decompose(st, 16, method="approach1")         # paper Alg. 3 on the remapped stream
    cp = decompose(st, 16, method="approach2", layout="copies")  # Alg. 4, one copy per mode
    tk = decompose(st, (16, 16, 16), format="tucker", method="reference")  # plain TTMc
    tt = decompose(st, (16, 16), format="tt", method="reference")          # plain TT-core
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .core.coo import SparseTensor
from .core.cp_als import CPState, cp_als
from .obs import trace as _trace
from .tt.als import TTState, tt_als
from .tucker.hooi import TuckerState, tucker_hooi

__all__ = ["decompose"]

_FORMATS = ("cp", "tucker", "tt")
# The methods each format takes: the planned kernel, or its plain path(s).
_METHODS = {"cp": ("pallas", "approach1", "approach2"), "tucker": ("pallas", "reference"),
            "tt": ("pallas", "reference")}


def decompose(
    st: SparseTensor,
    rank: int | Sequence[int],
    *,
    format: str = "cp",
    method: str = "pallas",
    iters: int = 10,
    seed: int = 0,
    tol: float | None = None,
    init_factors: Sequence | None = None,
    init: str | None = None,
    layout: str | None = None,
    mttkrp_fn: Callable | None = None,
    planned=None,
    auto_tune: bool | str = False,
    spec="default",
    cfg=None,
    device: str | torch.device | None = None,
    verbose: bool = False,
    trace=None,
) -> CPState | TuckerState | TTState:
    """Decompose a sparse tensor on the planned memory-controller kernels.

    Args:
      st: host-side COO tensor (>= 3 modes, any number).
      rank: the CP rank (int); the Tucker core ranks (N-tuple; an int
        broadcasts to every mode); or the N-1 interior TT ranks (an int
        broadcasts to every bond).
      format: 'cp' (CP-ALS), 'tucker' (HOOI) or 'tt' (TT-ALS).
      method: 'pallas' (the default): the format's planned CUDA kernel on
        one device-resident BlockPlan per mode, built once; for CP
        'approach1' / 'approach2', the paper's compute patterns on the raw
        stream (`core.mttkrp`); for Tucker and TT 'reference', the format's
        plain PyTorch right-hand side on the raw stream.
      layout / mttkrp_fn: CP only (see `cp_als`): 'remap' (the default) or
        'copies' for the stream of the compute patterns, and a callable
        that replaces the method's MTTKRP.
      iters / seed / tol / verbose: iteration count, init seed, host-side
        fit-change early exit, per-iteration fit printing.
      init_factors: initial factors, one (I_m, R_m) array per mode (Tucker's
        orthonormal), or for TT one (rl_m, I_m, rr_m) core per mode; without
        them a torch generator seeded with `seed` draws them (not the
        reference's numbers — see `cp_als`, `tucker_hooi` and `tt_als`),
        except TT's SVD init.
      init: TT only: 'auto' (the default), 'svd' or 'random' (see `tt_als`).
      planned: a prebuilt `PlannedCPALS`, `PlannedTucker` or `PlannedTT`
        whose plans are reused (method='pallas' only).
      auto_tune / spec / cfg: the plan geometry of a workspace built here:
        `cfg` (a `MemoryControllerConfig`) for every mode, or, with
        auto_tune=True, the PMS's pick per mode for the format's kernel
        (`repro_torch.core.pms.search`, analytic); "cached" serves each
        mode's winner from the autotune cache
        (`$REPRO_TORCH_AUTOTUNE_DIR`), searching and writing back on a
        miss.  `spec`: the PMS's hardware constants, a `GPUSpec`,
        "default" (the H100 data sheet) or "measured" (this card's fitted
        spec from the cache; calibrated on the card on a miss).
      device: CUDA unless given; raises when no GPU is present and no device
        was given.
      trace: tracing for this call (`repro_torch.obs.trace`): True collects
        spans into a fresh in-memory `Tracer`; a path collects AND exports
        them as JSONL on exit; an existing `Tracer` appends to it;
        None/False leaves the process-global state alone (so
        `REPRO_TORCH_TRACE=1` still applies).  Restores the previous tracer
        when the call returns.  The call is a `decompose` span, each plan
        build a `plan_build` span (synchronized on the card), the drive
        loop a `drive` span with one `sweep` span per iteration.

    Returns:
      `CPState(factors, lam, fit_history)`,
      `TuckerState(factors, core, fit_history)` or
      `TTState(cores, fit_history)`.
    """
    if format not in _FORMATS:
        raise ValueError(f"unknown format {format!r}: expected 'cp', 'tucker' or 'tt'")
    if method not in _METHODS[format]:
        raise ValueError(f"unknown method {method!r} for format={format!r}: expected one of "
                         f"{', '.join(repr(m) for m in _METHODS[format])}")
    if init is not None and format != "tt":
        raise ValueError(f"init= is taken by format='tt' only, not format={format!r}")
    if (layout is not None or mttkrp_fn is not None) and format != "cp":
        raise ValueError(f"layout= and mttkrp_fn= are taken by format='cp' only, not format={format!r}")
    if auto_tune not in (False, True, "cached"):
        raise ValueError(f"auto_tune must be False, True or 'cached', got {auto_tune!r}")
    if format == "cp" and not isinstance(rank, int):
        raise ValueError(f"format='cp' takes a single integer rank, got {rank!r}")
    tune = dict(auto_tune=auto_tune, spec=spec, cfg=cfg)
    with _trace.tracing(trace), _trace.span("decompose", format=format, method=method,
                                            shape=list(st.shape), nnz=st.nnz, iters=iters):
        if format == "tt":
            ranks = (rank,) * (st.nmodes - 1) if isinstance(rank, int) else tuple(int(r) for r in rank)
            return tt_als(st, ranks, iters=iters, method=method, tol=tol, init=init or "auto",
                          init_cores=init_factors, seed=seed, device=device, planned=planned,
                          verbose=verbose, **tune)
        if format == "tucker":
            ranks = (rank,) * st.nmodes if isinstance(rank, int) else tuple(int(r) for r in rank)
            return tucker_hooi(st, ranks, iters=iters, method=method, tol=tol,
                               init_factors=init_factors, seed=seed, device=device, planned=planned,
                               verbose=verbose, **tune)
        return cp_als(st, rank, iters=iters, method=method, layout=layout or "remap", tol=tol,
                      init_factors=init_factors, seed=seed, device=device, mttkrp_fn=mttkrp_fn,
                      planned=planned, verbose=verbose, **tune)
