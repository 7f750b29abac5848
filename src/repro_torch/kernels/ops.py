"""Planned MTTKRP, TTMc and TT-core ops, the planned CP-ALS workspace, and
the one-shot dispatchers with their plan cache.

Counterpart of the single-device parts of `repro.kernels.ops`:
`PlannedMTTKRP` / `PlannedTTMC` / `PlannedTTCore` hold one output mode's
device-resident BlockPlan and run their kernel on it (for one tensor, mode
and config all get the same plan: the kernel adapts to the layout);
`PlannedCPALS` holds one per mode, built once and reused by every ALS
iteration (the plan/remap cost is amortized over the decomposition).  Every
`make_planned_*` takes `cfg=`, or `auto_tune=` and `spec=` to let the PMS
(core/pms.py) pick each mode's configuration for its kernel.
`mttkrp_auto` / `tucker_auto` / `tt_auto` compute one mode's MTTKRP, TTM
chain or TT-core right-hand side in one call, their plans kept in a shared
LRU cache keyed by the tensor's content (`plan_cache_stats`).  No sharding
yet.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict
from typing import Callable, Sequence

import torch

from ..core.coo import SparseTensor, to_device
from ..core.cp_als import _update_mode, fit_value
from ..core.memctrl import GPUSpec, MemoryControllerConfig
from ..core.mttkrp import mttkrp as mttkrp_stream
from ..core.mttkrp import mttkrp_approach1
from ..core.pms import predict_from_plan
from ..core.pms import resolve_spec as pms_resolve_spec
from ..core.pms import search as pms_search
from ..core.remap import BlockPlan, plan_blocks, plans_validated, validate_plan
from ..device import resolve_device
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .mttkrp import mttkrp_blocked, pad_factor, rank_padded
from .ref import ttcore_ref, ttmc_ref
from .tt import tt_out_cols, tt_out_pair, ttcore_blocked
from .ttm import kron_cols, ttmc_blocked
from .workspace import PlannedWorkspace

__all__ = [
    "PlannedMTTKRP",
    "make_planned_mttkrp",
    "PlannedTTMC",
    "make_planned_ttmc",
    "PlannedTTCore",
    "make_planned_ttcore",
    "PlannedCPALS",
    "make_planned_cp_als",
    "mttkrp_auto",
    "plan_cache_clear",
    "plan_cache_config",
    "plan_cache_stats",
    "tt_auto",
    "tucker_auto",
]


@dataclasses.dataclass
class PlannedMTTKRP:
    """One (tensor, output mode): the device-resident BlockPlan and a
    callable running the MTTKRP kernel on it."""

    plan: BlockPlan
    rank: int
    cfg: MemoryControllerConfig = dataclasses.field(default_factory=MemoryControllerConfig)

    def __call__(self, *in_factors: torch.Tensor) -> torch.Tensor:
        """True-shape factors of the N-1 input modes (plan.in_modes order).
        Returns (plan.out_rows, rank)."""
        p = self.plan
        if len(in_factors) != p.n_in:
            raise ValueError(f"{len(in_factors)} factors for {p.n_in} input modes")
        rp = rank_padded(self.rank)
        pads = [pad_factor(f, rows, rp) for f, rows in zip(in_factors, p.in_rows)]
        return mttkrp_blocked(p, pads)[:, : self.rank]

    def output(self, factors: Sequence[torch.Tensor], true_rows: int) -> torch.Tensor:
        """The mode's MTTKRP from ALL N factors (the output mode's is
        ignored), cut to the mode's true rows."""
        return self(*(factors[m] for m in self.plan.in_modes))[:true_rows]


def _plan(st: SparseTensor, mode: int, cfg: MemoryControllerConfig,
          device: str | torch.device | None) -> BlockPlan:
    """One mode's memory layout (the Tensor Remapper) on `device`."""
    return plan_blocks(
        st,
        mode,
        tile_i=cfg.cache.tile_i,
        blk=cfg.dma.blk,
        in_tiles=cfg.cache.input_tiles(st.nmodes - 1),
        device=resolve_device(device),
    )


def _resolve_tune(auto_tune, spec) -> tuple[bool | str, GPUSpec]:
    """Normalize the (auto_tune, spec) pair every `make_planned_*` takes:
    `auto_tune` is False, True or "cached" (True, with the winner kept in
    `repro_torch.tune.cache`, so a warm cache skips the search); `spec` a
    GPUSpec, "default" or "measured" (this backend's fitted spec)."""
    if auto_tune not in (False, True, "cached"):
        raise ValueError(f"auto_tune must be False, True or 'cached', got {auto_tune!r}")
    return auto_tune, pms_resolve_spec(spec)


def _searched_cfg(auto_tune, kind: str, st: SparseTensor, mode: int, rank_key,
                  spec: GPUSpec) -> MemoryControllerConfig:
    """The analytic PMS search's winner for one mode of kernel `kind` at
    `rank_key` (the CP rank, TTMc's N core ranks or TT's N-1 bond ranks):
    searched on every call for auto_tune=True; for "cached", the persisted
    winner of this (kind, tensor, mode, rank payload, backend, spec),
    searched and written back only on a miss.  Raises where no
    configuration fits the kernel's shared memory."""

    def search():
        rank, core_ranks = (rank_key, None) if kind == "mttkrp" else (0, rank_key)
        best = pms_search(st, mode, rank, spec=spec, top_k=1, kernel=kind, core_ranks=core_ranks)
        if not best:
            raise ValueError(
                f"PMS found no controller configuration whose {kind} kernel fits "
                f"shared memory for mode {mode} at ranks {rank_key!r} (spec budget "
                f"{spec.smem_per_block} bytes per CTA)")
        return best[0].cfg

    if auto_tune == "cached":
        from ..tune.cache import cached_config  # deferred: tune -> ops

        return cached_config(kind, st.fingerprint(), mode, rank_key, spec, search)
    return search()


def make_planned_mttkrp(
    st: SparseTensor,
    mode: int,
    rank: int,
    *,
    cfg: MemoryControllerConfig | None = None,
    auto_tune: bool | str = False,
    spec: GPUSpec | str = GPUSpec(),
    device: str | torch.device | None = None,
) -> PlannedMTTKRP:
    """Build one mode's memory layout (the Tensor Remapper) on `device`,
    at `cfg` (or the default), or at the PMS's pick for the MTTKRP kernel
    with auto_tune=True or "cached" (then `cfg` is ignored)."""
    auto_tune, spec = _resolve_tune(auto_tune, spec)
    if auto_tune:
        cfg = _searched_cfg(auto_tune, "mttkrp", st, mode, rank, spec)
    cfg = cfg or MemoryControllerConfig()
    return PlannedMTTKRP(plan=_plan(st, mode, cfg, device), rank=rank, cfg=cfg)


@dataclasses.dataclass
class PlannedTTMC:
    """One (tensor, output mode) for the TTM-chain kernel: the same
    device-resident BlockPlan as MTTKRP's, and the input-factor ranks
    `in_ranks` in plan.in_modes order; the output has prod(in_ranks) true
    columns."""

    plan: BlockPlan
    in_ranks: tuple[int, ...]
    cfg: MemoryControllerConfig = dataclasses.field(default_factory=MemoryControllerConfig)

    @property
    def out_cols(self) -> int:
        return kron_cols(self.in_ranks)

    def __call__(self, *in_factors: torch.Tensor) -> torch.Tensor:
        """True-shape factors of the N-1 input modes (plan.in_modes order).
        Returns (plan.out_rows, prod(in_ranks))."""
        p = self.plan
        if len(in_factors) != p.n_in:
            raise ValueError(f"{len(in_factors)} factors for {p.n_in} input modes")
        pads = [pad_factor(f, rows, rank_padded(r))
                for f, rows, r in zip(in_factors, p.in_rows, self.in_ranks)]
        return ttmc_blocked(p, pads, self.in_ranks)[:, : self.out_cols]

    def output(self, factors: Sequence[torch.Tensor], true_rows: int) -> torch.Tensor:
        """The unfolding Y_(mode) from ALL N factors (the output mode's is
        ignored), cut to the mode's true rows."""
        return self(*(factors[m] for m in self.plan.in_modes))[:true_rows]


def make_planned_ttmc(
    st: SparseTensor,
    mode: int,
    core_ranks: Sequence[int],
    *,
    cfg: MemoryControllerConfig | None = None,
    auto_tune: bool | str = False,
    spec: GPUSpec | str = GPUSpec(),
    device: str | torch.device | None = None,
) -> PlannedTTMC:
    """Build one output mode's layout for the TTMc kernel on `device`.

    `core_ranks` is the FULL N-tuple of Tucker core ranks; the op's
    `in_ranks` are taken from it in plan.in_modes order.  The plan is the
    one `make_planned_mttkrp` builds for the same (tensor, mode, cfg).
    auto_tune / spec: let the PMS pick the configuration for the TTMc
    kernel at these ranks (as `make_planned_mttkrp`)."""
    core_ranks = tuple(int(r) for r in core_ranks)
    if len(core_ranks) != st.nmodes:
        raise ValueError(
            f"core_ranks has {len(core_ranks)} entries for a {st.nmodes}-mode tensor "
            f"(pass the full N-tuple)")
    auto_tune, spec = _resolve_tune(auto_tune, spec)
    if auto_tune:
        cfg = _searched_cfg(auto_tune, "ttmc", st, mode, core_ranks, spec)
    cfg = cfg or MemoryControllerConfig()
    plan = _plan(st, mode, cfg, device)
    return PlannedTTMC(plan=plan, in_ranks=tuple(core_ranks[m] for m in plan.in_modes), cfg=cfg)


def _tt_bond_pairs(tt_ranks: Sequence[int], nmodes: int) -> tuple[tuple[int, int], ...]:
    """Per-core (rl_k, rr_k) bond pairs from the N-1 interior TT ranks
    (boundary bonds are 1 by definition)."""
    tt_ranks = tuple(int(r) for r in tt_ranks)
    if len(tt_ranks) != nmodes - 1:
        raise ValueError(
            f"tt_ranks has {len(tt_ranks)} entries for a {nmodes}-mode "
            f"tensor (pass the N-1 interior TT ranks)")
    bounds = (1,) + tt_ranks + (1,)
    return tuple((bounds[k], bounds[k + 1]) for k in range(nmodes))


@dataclasses.dataclass
class PlannedTTCore:
    """One (tensor, output mode) for the TT-core kernel: the same
    device-resident BlockPlan as MTTKRP's, and the input cores' (rl, rr)
    bond pairs `in_rank_pairs` in plan.in_modes order (ascending, so the
    first `plan.mode` of them chain from the left); the output has
    rl_m * rr_m true columns."""

    plan: BlockPlan
    in_rank_pairs: tuple[tuple[int, int], ...]
    cfg: MemoryControllerConfig = dataclasses.field(default_factory=MemoryControllerConfig)

    @property
    def n_left(self) -> int:
        """Inputs left of the output mode: plan.in_modes is ascending, so
        exactly `plan.mode` of them precede it."""
        return self.plan.mode

    @property
    def out_pair(self) -> tuple[int, int]:
        return tt_out_pair(self.in_rank_pairs, self.n_left)

    @property
    def out_cols(self) -> int:
        return tt_out_cols(self.in_rank_pairs, self.n_left)

    def __call__(self, *in_mats: torch.Tensor) -> torch.Tensor:
        """True-shape interface matrices W_k (I_k, rl_k * rr_k) of the N-1
        input modes (plan.in_modes order).  Returns (plan.out_rows, rl_m *
        rr_m); the wrapper's output is zeroed, so rows no non-zero reaches
        are 0 without a row mask."""
        p = self.plan
        if len(in_mats) != p.n_in:
            raise ValueError(f"{len(in_mats)} interface matrices for {p.n_in} input modes")
        pads = [pad_factor(w, rows, rank_padded(a * b))
                for w, rows, (a, b) in zip(in_mats, p.in_rows, self.in_rank_pairs)]
        return ttcore_blocked(p, pads, self.in_rank_pairs, self.n_left)[:, : self.out_cols]

    def output(self, mats: Sequence[torch.Tensor], true_rows: int) -> torch.Tensor:
        """B_m from ALL N interface matrices (the output mode's is ignored),
        cut to the mode's true rows."""
        return self(*(mats[m] for m in self.plan.in_modes))[:true_rows]


def make_planned_ttcore(
    st: SparseTensor,
    mode: int,
    tt_ranks: Sequence[int],
    *,
    cfg: MemoryControllerConfig | None = None,
    auto_tune: bool | str = False,
    spec: GPUSpec | str = GPUSpec(),
    device: str | torch.device | None = None,
) -> PlannedTTCore:
    """Build one output mode's layout for the TT-core kernel on `device`.

    `tt_ranks` are the N-1 INTERIOR TT bond ranks (boundary bonds are 1);
    the op's `in_rank_pairs` are the per-core (rl, rr) pairs in
    plan.in_modes order.  The plan is the one `make_planned_mttkrp` builds
    for the same (tensor, mode, cfg).  auto_tune / spec: let the PMS pick
    the configuration for the TT-core kernel at these ranks (as
    `make_planned_mttkrp`)."""
    pairs = _tt_bond_pairs(tt_ranks, st.nmodes)
    auto_tune, spec = _resolve_tune(auto_tune, spec)
    if auto_tune:
        cfg = _searched_cfg(auto_tune, "tt", st, mode, tuple(int(r) for r in tt_ranks), spec)
    cfg = cfg or MemoryControllerConfig()
    plan = _plan(st, mode, cfg, device)
    return PlannedTTCore(plan=plan, in_rank_pairs=tuple(pairs[m] for m in plan.in_modes), cfg=cfg)


@dataclasses.dataclass
class PlannedCPALS(PlannedWorkspace):
    """Per-mode plans driving the whole CP-ALS loop: one `PlannedMTTKRP` per
    output mode, built once; the drive loop and padding come from
    `PlannedWorkspace`, this class supplies the CP sweep."""

    ops: dict[int, PlannedMTTKRP]
    shape: tuple[int, ...]
    rank: int

    @property
    def lane_ranks(self) -> tuple[int, ...]:
        return (self.rank,) * self.nmodes

    @property
    def rank_pad(self) -> int:
        return rank_padded(self.rank)

    @property
    def device(self) -> torch.device:
        return self.ops[0].plan.device

    def plan_for(self, mode: int) -> BlockPlan:
        return self.ops[mode].plan

    def _geoms(self) -> dict[int, BlockPlan]:
        return {m: op.plan for m, op in self.ops.items()}

    def smem_model_bytes(self, spec: GPUSpec = GPUSpec()) -> int:
        """Shared memory per CTA of the widest mode's MTTKRP launch."""
        return max(op.cfg.mttkrp_launch(spec, self.rank_pad, op.plan.n_in).smem_bytes
                   for op in self.ops.values())

    def pms_estimates(self, spec: GPUSpec | str = GPUSpec()) -> dict:
        """Exact per-mode PMS estimates from the built plans (measured fills
        and padding): the predicted side of `obs.calibrate`."""
        return {m: predict_from_plan(op.plan, self.rank, op.cfg, spec) for m, op in self.ops.items()}

    def mttkrp_fn(self, indices, values, factors, mode: int, out_rows: int) -> torch.Tensor:
        """The `cp_als(mttkrp_fn=...)` seam: the stream arguments are
        ignored, since each mode's remapped copy already lives in its plan."""
        return self.ops[mode].output(factors, out_rows)

    def sweep(self, facs, idx, val, norm_x_sq, *, first: bool = False):
        """One ALS iteration in padded space.

        `facs` is the padded factor tuple (`pad_factors` or a previous
        sweep's result).  Each mode's new factor is written IN PLACE into
        the true block of its padded tensor (padding rows and lanes stay
        exactly 0), so a sweep allocates no new padded factors.  `idx`,
        `val`: the raw COO stream on the device, read only by the fit;
        `norm_x_sq`: ||X||_F^2 as a device scalar; `first`: the
        first-iteration normalization.  Returns (padded factors, lam, fit)."""
        shape, rank = self.shape, self.rank
        facs = tuple(facs)
        lam = None
        for m in range(self.nmodes):
            p = self.ops[m].plan
            in_facs = [facs[im][: p.in_rows[n]] for n, im in enumerate(p.in_modes)]
            mt = mttkrp_blocked(p, in_facs)[: shape[m], :rank]
            true = [f[:s, :rank] for f, s in zip(facs, shape)]
            true, lam = _update_mode(mt, true, m, first)
            facs[m][: shape[m], :rank] = true[m]
        true = [f[:s, :rank] for f, s in zip(facs, shape)]
        fit = fit_value(idx, val, true, lam, norm_x_sq)
        return facs, lam, fit

    def _build_fallback_sweep(self):
        """The "fallback" guard policy's target: the same ALS iteration with
        each mode's kernel replaced by approach 1 on the raw stream (which
        the drive's arguments carry for the fit), in any order
        (`sorted_by_mode=False`: a scatter-add); on the same padded
        factors, written in place.  Launches no kernel."""
        shape, rank, nmodes = self.shape, self.rank, self.nmodes

        def sweep(facs, idx, val, norm_x_sq, *, it: int):
            facs = tuple(facs)
            lam = None
            for m in range(nmodes):
                true = [f[:s, :rank] for f, s in zip(facs, shape)]
                mt = mttkrp_approach1(idx, val, true, m, shape[m], sorted_by_mode=False)
                true, lam = _update_mode(mt, true, m, it == 0)
                facs[m][: shape[m], :rank] = true[m]
            true = [f[:s, :rank] for f, s in zip(facs, shape)]
            return facs, lam, fit_value(idx, val, true, lam, norm_x_sq)

        return sweep


def make_planned_cp_als(
    st: SparseTensor,
    rank: int,
    *,
    cfg: MemoryControllerConfig | None = None,
    auto_tune: bool | str = False,
    spec: GPUSpec | str = GPUSpec(),
    device: str | torch.device | None = None,
) -> PlannedCPALS:
    """Build the ALS workspace: one plan per output mode on `device` (CUDA
    unless given).  This is the whole layout-generation cost the
    decomposition amortizes.  `cfg` is shared by every mode; with
    auto_tune=True or "cached" the PMS picks each mode's configuration
    instead (modes differ in shape and locality, Sec. 5.3)."""
    device = resolve_device(device)
    ops = {m: make_planned_mttkrp(st, m, rank, cfg=cfg, auto_tune=auto_tune, spec=spec,
                                  device=device)
           for m in range(st.nmodes)}
    return PlannedCPALS(ops=ops, shape=st.shape, rank=rank)


# ---------------------------------------------------------------------------
# The plan cache of the one-shot dispatchers (mttkrp_auto / tucker_auto /
# tt_auto)
# ---------------------------------------------------------------------------

_PLAN_CACHE: OrderedDict[tuple, "PlannedMTTKRP | PlannedTTMC | PlannedTTCore"] = OrderedDict()
# LRU bound: each entry pins a device-resident layout (1.7 GB at NELL-2
# size), so an unbounded cache would let a caller that churns tensors grow
# resident device memory without limit.  Set by REPRO_PLAN_CACHE_MAX when the
# module is imported, and by plan_cache_config.
_PLAN_CACHE_CAP = max(1, int(os.environ.get("REPRO_PLAN_CACHE_MAX", "32")))
_PLAN_CACHE_KINDS = ("mttkrp", "ttmc", "tt")
_PLAN_CACHE_STATS = {k: {"hits": 0, "misses": 0} for k in _PLAN_CACHE_KINDS}
_PLAN_CACHE_EVICTIONS = {"count": 0}


def plan_cache_config(maxsize: int | None = None) -> int:
    """Get, and with an integer set, the plan cache's LRU bound (>= 1).
    Setting it evicts least recently used entries down to the bound
    (counted in `plan_cache_stats()["evictions"]`).  Returns the bound."""
    global _PLAN_CACHE_CAP
    if maxsize is not None:
        if maxsize < 1:
            raise ValueError(f"plan cache maxsize must be >= 1, got {maxsize}")
        _PLAN_CACHE_CAP = int(maxsize)
        _evict_to_cap()
    return _PLAN_CACHE_CAP


def _evict_to_cap() -> None:
    while len(_PLAN_CACHE) > _PLAN_CACHE_CAP:
        key, _ = _PLAN_CACHE.popitem(last=False)
        _PLAN_CACHE_EVICTIONS["count"] += 1
        _metrics.counter("plan_cache.evictions").inc()
        _trace.event("plan_cache_evict", kind=str(key[0]), mode=int(key[2]))


def plan_cache_stats() -> dict:
    """The shared plan cache's counters: {"hits", "misses", "evictions",
    "size", "maxsize", "by_kind": {"mttkrp" | "ttmc" | "tt": {"hits",
    "misses"}}}.  A hit is a dispatcher call that skipped the layout build;
    the key carries the kernel kind, so kinds never alias.  Reset by
    `plan_cache_clear()`."""
    by_kind = {k: dict(v) for k, v in _PLAN_CACHE_STATS.items()}
    return {
        "hits": sum(v["hits"] for v in by_kind.values()),
        "misses": sum(v["misses"] for v in by_kind.values()),
        "evictions": _PLAN_CACHE_EVICTIONS["count"],
        "size": len(_PLAN_CACHE),
        "maxsize": _PLAN_CACHE_CAP,
        "by_kind": by_kind,
    }


def plan_cache_clear() -> None:
    """Drop every cached plan (their device memory with them) and zero the
    counters."""
    _PLAN_CACHE.clear()
    for v in _PLAN_CACHE_STATS.values():
        v["hits"] = 0
        v["misses"] = 0
    _PLAN_CACHE_EVICTIONS["count"] = 0


def _planned_cached(kind: str, st: SparseTensor, mode: int, rank_key,
                    cfg: MemoryControllerConfig | None, device: torch.device, build: Callable):
    """LRU-cached op keyed by (kernel kind, the tensor's content
    fingerprint, mode, rank key, controller config, device): a repeated
    call stops paying for the Tensor Remapper.  The kind keeps MTTKRP, TTMc
    and TT-core ops of one tensor, mode and rank apart.  With
    REPRO_VALIDATE_PLANS set, a hit validates the cached plan again.  Traced
    as a `plan_cache_hit` event or a `plan_cache_build` span."""
    key = (kind, st.fingerprint(), mode, rank_key, cfg or MemoryControllerConfig(), device)
    stats = _PLAN_CACHE_STATS[kind]
    t0 = time.perf_counter()
    op = _PLAN_CACHE.get(key)
    if op is not None:
        stats["hits"] += 1
        _PLAN_CACHE.move_to_end(key)
        if plans_validated():
            validate_plan(op.plan)
        _metrics.counter("plan_cache.hits", kind=kind).inc()
        _metrics.histogram("plan_cache.hit_seconds", kind=kind).observe(time.perf_counter() - t0)
        _trace.event("plan_cache_hit", kind=kind, mode=mode)
        return op
    stats["misses"] += 1
    with _trace.span("plan_cache_build", kind=kind, mode=mode):
        op = build()
    _PLAN_CACHE[key] = op
    _evict_to_cap()
    _metrics.counter("plan_cache.misses", kind=kind).inc()
    _metrics.histogram("plan_cache.miss_build_seconds", kind=kind).observe(
        time.perf_counter() - t0)
    return op


def mttkrp_auto(
    st: SparseTensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    *,
    method: str = "pallas",
    cfg: MemoryControllerConfig | None = None,
    sorted_by_mode: bool | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """One mode's MTTKRP in one call: 'pallas' (the planned kernel, its
    plan cached by the tensor's content; see `plan_cache_stats`),
    'approach1' or 'approach2' (the compute patterns on the raw stream).

    factors: ALL N factors, (I_m, R) each; moved to `device` (CUDA unless
      given; raises when no GPU is present and no device was given).
    sorted_by_mode: approach 1's promise that the stream is sorted by
      `mode`; by default what the stream satisfies (`st.is_sorted_by`), so
      it is never made for an unsorted stream.
    Returns (I_mode, R) float32."""
    device = resolve_device(device)
    factors = [f.to(device) for f in factors]
    rank = int(factors[0].shape[1])
    if method == "pallas":
        op = _planned_cached("mttkrp", st, mode, rank, cfg, device,
                             lambda: make_planned_mttkrp(st, mode, rank, cfg=cfg, device=device))
        return op.output(factors, st.shape[mode])
    if sorted_by_mode is None:
        sorted_by_mode = st.is_sorted_by(mode)
    idx, val = to_device(st, device)
    return mttkrp_stream(idx, val, factors, mode, st.shape[mode], method=method,
                         sorted_by_mode=sorted_by_mode)


def tucker_auto(
    st: SparseTensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    *,
    method: str = "pallas",
    cfg: MemoryControllerConfig | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """One mode's sparse TTM chain in one call: every factor but `mode`'s
    contracted into X.  'pallas' runs the planned TTMc kernel, its plan
    cached under the input ranks; 'reference' the chunked `ttmc_ref` on the
    raw stream.

    factors: ALL N factors, (I_m, R_m) each, on `device` as `mttkrp_auto`.
    Returns the unfolding Y_(mode), (I_mode, prod of the input ranks),
    float32, columns row-major over ascending input mode."""
    device = resolve_device(device)
    factors = [f.to(device) for f in factors]
    core_ranks = tuple(int(f.shape[1]) for f in factors)
    if method == "pallas":
        in_ranks = tuple(r for m, r in enumerate(core_ranks) if m != mode)
        op = _planned_cached("ttmc", st, mode, in_ranks, cfg, device,
                             lambda: make_planned_ttmc(st, mode, core_ranks, cfg=cfg, device=device))
        return op.output(factors, st.shape[mode])
    if method != "reference":
        raise ValueError(f"unknown method {method!r}: expected 'pallas' or 'reference'")
    idx, val = to_device(st, device)
    return ttmc_ref(idx, val, factors, mode, st.shape[mode])


def tt_auto(
    st: SparseTensor,
    cores: Sequence[torch.Tensor],
    mode: int,
    *,
    method: str = "pallas",
    cfg: MemoryControllerConfig | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """One mode's TT-ALS right-hand side B_mode in one call, from the left
    and right interface chains of the other cores.  'pallas' runs the
    planned TT-core kernel, its plan cached under the input cores' bond
    pairs; 'reference' the chunked `ttcore_ref` on the raw stream.

    cores: ALL N TT cores, (rl_k, I_k, rr_k) with boundary bonds 1, on
      `device` as `mttkrp_auto`; the mode-th core's bonds set the width.
    Returns (I_mode, rl_mode * rr_mode) float32, columns row-major over
    (rl, rr)."""
    device = resolve_device(device)
    cores = [c.to(device) for c in cores]
    pairs = tuple((int(c.shape[0]), int(c.shape[2])) for c in cores)
    if method == "pallas":
        in_pairs = tuple(p for m, p in enumerate(pairs) if m != mode)
        tt_ranks = tuple(pairs[k][1] for k in range(len(cores) - 1))
        op = _planned_cached("tt", st, mode, in_pairs, cfg, device,
                             lambda: make_planned_ttcore(st, mode, tt_ranks, cfg=cfg, device=device))
        mats = [c.permute(1, 0, 2).reshape(c.shape[1], -1) for c in cores]
        return op.output(mats, st.shape[mode])
    if method != "reference":
        raise ValueError(f"unknown method {method!r}: expected 'pallas' or 'reference'")
    idx, val = to_device(st, device)
    return ttcore_ref(idx, val, cores, mode, st.shape[mode])
