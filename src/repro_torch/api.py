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
    cp = decompose(st, 16, guards=GuardConfig("fallback"))   # NaN -> the reference sweep
    cp = decompose(st, 16, hbm_budget=2 * 1024**3)     # admission ladder under a budget
    cp = decompose(st, 16, checkpoint_path="ckpt")     # checkpoints, resumed on the next call
    cp = decompose(st, 16, method="pallas_sharded", devices=2)   # 2 shards on 2 cards
    cp = decompose(st, 16, method="pallas_sharded",
                   dist=shard_plan(["cuda:0"] * 4))    # 4 shards on one card, in turn
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .core.coo import SparseTensor
from .core.cp_als import CPState, cp_als
from .device import resolve_device
from .obs import trace as _trace
from .tt.als import TTState, tt_als
from .tucker.hooi import TuckerState, tucker_hooi

__all__ = ["decompose"]

_FORMATS = ("cp", "tucker", "tt")
# The methods each format takes: the planned kernel, or its plain path(s).
_METHODS = {"cp": ("pallas", "pallas_sharded", "approach1", "approach2"),
            "tucker": ("pallas", "pallas_sharded", "reference"),
            "tt": ("pallas", "pallas_sharded", "reference")}


def _lane_ranks(format: str, r, nmodes: int) -> tuple[int, ...]:
    """Each mode's factor lane width (`PlannedWorkspace.lane_ranks`) without
    building a workspace: sizes the ladder's reference rung."""
    if format == "cp":
        return (r,) * nmodes
    if format == "tucker":
        return tuple(r)
    bounds = (1,) + tuple(r) + (1,)
    return tuple(bounds[m] * bounds[m + 1] for m in range(nmodes))


def _admitted(st: SparseTensor, r, *, format: str, method: str, planned, hbm_budget: int,
              auto_tune, cfg, device, verbose: bool):
    """`hbm_budget=`: admit a given workspace as it is, or run the ladder
    (`repro_torch.resilience.plan_with_budget`) over workspaces built here,
    stepping the block size down, then to the reference method, then
    raising `AdmissionError`.  Returns the workspace (None on the
    reference rung) and the method to run."""
    from .resilience import AdmissionError, admit, plan_with_budget, reference_footprint_bytes

    reference_method = "approach1" if format == "cp" else "reference"
    ref_bytes = reference_footprint_bytes(st, _lane_ranks(format, r, st.nmodes))
    if method != "pallas":
        if ref_bytes > hbm_budget:
            raise AdmissionError(hbm_budget, [], ref_bytes)
        return planned, method
    if planned is not None:
        admit(planned, hbm_budget)
        return planned, method
    if auto_tune:
        raise ValueError("hbm_budget's degradation ladder steps the controller config "
                         "explicitly; it is incompatible with auto_tune=True")
    if format == "cp":
        from .kernels.ops import make_planned_cp_als as build_ws
    elif format == "tucker":
        from .tucker.hooi import make_planned_tucker as build_ws
    else:
        from .tt.als import make_planned_tt as build_ws
    ws, decision = plan_with_budget(lambda c: build_ws(st, r, cfg=c, device=device),
                                    hbm_budget, cfg=cfg, reference_bytes=ref_bytes)
    if verbose:
        rungs = ", ".join(f"blk={a['blk']}:{a['total_bytes']:,}B" for a in decision["ladder"])
        print(f"[admission] {decision['admitted']} admitted under {hbm_budget:,}B "
              f"(ladder: {rungs or 'none'})")
    if ws is None:
        return None, reference_method
    return ws, method


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
    devices=None,
    dist=None,
    verbose: bool = False,
    trace=None,
    guards=None,
    hbm_budget: int | None = None,
    checkpoint_every: int | None = None,
    checkpoint_path=None,
) -> CPState | TuckerState | TTState:
    """Decompose a sparse tensor on the planned memory-controller kernels.

    Args:
      st: host-side COO tensor (>= 3 modes, any number).
      rank: the CP rank (int); the Tucker core ranks (N-tuple; an int
        broadcasts to every mode); or the N-1 interior TT ranks (an int
        broadcasts to every bond).
      format: 'cp' (CP-ALS), 'tucker' (HOOI) or 'tt' (TT-ALS).
      method: 'pallas' (the default): the format's planned CUDA kernel on
        one device-resident BlockPlan per mode, built once;
        'pallas_sharded': the sharded planned path, each mode's stream
        split into balanced output-tile ranges with one plan per shard on
        its device, the kernel launched once per shard and the partial
        outputs reduced onto the first shard's device; for CP
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
        (method='pallas'), or their `Sharded*` counterparts
        (method='pallas_sharded'), whose plans are reused; checked against
        `format` and `method`.
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
      devices / dist: the placement of method='pallas_sharded', in place of
        `device`: a `repro_torch.dist.ShardingPlan`, or what
        `repro_torch.dist.planned.shard_plan` takes (a count of CUDA
        devices, or a sequence of devices, repeats allowed:
        ["cpu"] * 4 runs 4 shards on the CPU).
      trace: tracing for this call (`repro_torch.obs.trace`): True collects
        spans into a fresh in-memory `Tracer`; a path collects AND exports
        them as JSONL on exit; an existing `Tracer` appends to it;
        None/False leaves the process-global state alone (so
        `REPRO_TORCH_TRACE=1` still applies).  Restores the previous tracer
        when the call returns.  The call is a `decompose` span, each plan
        build a `plan_build` span (synchronized on the card), the drive
        loop a `drive` span with one `sweep` span per iteration.
      guards: a `repro_torch.resilience.GuardConfig`: numerical guards in
        the planned drive loop (a non-finite fit, a sustained regression,
        non-finite factors on a cadence) with raise, restart or fallback
        (to the format's plain reference sweep) recovery.
      hbm_budget: device-memory admission (method='pallas' and the
        reference methods; refused for 'pallas_sharded'): the workspace's
        footprint (`plan_bytes()`, the padded factors and its kernel's
        shared memory per CTA) must fit this many bytes.  Over budget,
        the ladder halves the block size down to `FLOOR_BLK`, then takes
        the reference method ('approach1' for CP, 'reference' otherwise),
        and only then raises `AdmissionError`.  A given `planned=` is admitted as it is;
        auto_tune=True is refused.
      checkpoint_every / checkpoint_path: save the padded factors and the
        fits every k iterations; a directory that holds a checkpoint
        resumes from it.

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
    if (devices is not None or dist is not None) and device is not None:
        raise ValueError("device= and devices=/dist= were both passed: method='pallas_sharded' "
                         "places its shards by devices=/dist=, every other method by device=")
    if hbm_budget is not None and method == "pallas_sharded":
        raise ValueError("hbm_budget applies to method='pallas' and the reference methods, "
                         "got method='pallas_sharded'")
    if format == "cp" and not isinstance(rank, int):
        raise ValueError(f"format='cp' takes a single integer rank, got {rank!r}")
    if format == "tt":
        r = (rank,) * (st.nmodes - 1) if isinstance(rank, int) else tuple(int(x) for x in rank)
    elif format == "tucker":
        r = (rank,) * st.nmodes if isinstance(rank, int) else tuple(int(x) for x in rank)
    else:
        r = rank
    with _trace.tracing(trace), _trace.span("decompose", format=format, method=method,
                                            shape=list(st.shape), nnz=st.nnz, iters=iters):
        if hbm_budget is not None:
            planned, method = _admitted(st, r, format=format, method=method, planned=planned,
                                        hbm_budget=hbm_budget, auto_tune=auto_tune, cfg=cfg,
                                        device=resolve_device(device), verbose=verbose)
        common = dict(iters=iters, method=method, tol=tol, seed=seed, device=device,
                      devices=devices, dist=dist, planned=planned, verbose=verbose,
                      auto_tune=auto_tune, spec=spec, cfg=cfg, guards=guards,
                      checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path)
        if format == "tt":
            return tt_als(st, r, init=init or "auto", init_cores=init_factors, **common)
        if format == "tucker":
            return tucker_hooi(st, r, init_factors=init_factors, **common)
        return cp_als(st, r, layout=layout or "remap", init_factors=init_factors,
                      mttkrp_fn=mttkrp_fn, **common)
