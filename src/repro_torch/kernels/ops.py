"""Planned MTTKRP, TTMc and TT-core ops, and the planned CP-ALS workspace.

Counterpart of the MTTKRP, TTMc and TT-core parts of `repro.kernels.ops`:
`PlannedMTTKRP` / `PlannedTTMC` / `PlannedTTCore` hold one output mode's
device-resident BlockPlan and run their kernel on it (for one tensor, mode
and config all get the same plan: the kernel adapts to the layout);
`PlannedCPALS` holds
one per mode, built once and reused by every ALS iteration (the plan/remap
cost is amortized over the decomposition).  Every `make_planned_*` takes
`cfg=`, or `auto_tune=` and `spec=` to let the PMS (core/pms.py) pick each
mode's configuration for its kernel.  No plan cache and no sharding yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..core.coo import SparseTensor
from ..core.cp_als import _update_mode, fit_value
from ..core.memctrl import GPUSpec, MemoryControllerConfig
from ..core.pms import predict_from_plan
from ..core.pms import resolve_spec as pms_resolve_spec
from ..core.pms import search as pms_search
from ..core.remap import BlockPlan, plan_blocks
from ..device import resolve_device
from .mttkrp import mttkrp_blocked, pad_factor, rank_padded
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
