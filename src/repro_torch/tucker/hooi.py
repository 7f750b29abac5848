"""Sparse Tucker decomposition (HOOI) on the planned TTMc kernel.

Counterpart of `repro.tucker.hooi` for its planned path (`method="pallas"`)
and its reference method.  Each HOOI iteration runs, for each mode n,

    Y_(n) = X_(n) (kron of U^(m), m != n)     # sparse TTMc: the kernel
    U^(n) = top-R_n left singular vectors of Y_(n)

then folds the core from the last mode's Y and takes the fit from its norm
(the factors are orthonormal):

    G = Y_(N-1) x_{N-1} U^(N-1)^T
    fit = 1 - sqrt(||X||^2 - ||G||^2) / ||X||

The truncated SVD goes through the (P, P) Gram of the unfolding, P the
product of the other core ranks, so `eigh` never sees an I_n-sized matrix.
PyTorch runs eagerly, so the sweep is a Python loop over modes where the
reference jits it.  The Gram and the eigh stay in float32, as in the
reference (a float64 or SVD route would move the fits away from it), and
rely on PyTorch's default "highest" float32 matmul precision: the
eigenvectors of a TF32 Gram would move the fits too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..core.coo import SparseTensor, norm_sq, to_device
from ..core.loop import (
    check_drive_extras,
    check_planned_method,
    check_workspace,
    finish_iter,
    given_factors,
)
from ..core.memctrl import GPUSpec, MemoryControllerConfig
from ..core.pms import predict_ttmc
from ..device import resolve_device
from ..dist.collective import Replicas, reduce_partials
from ..kernels.ops import (
    PlannedTTMC,
    _resolve_dist,
    _ShardStack,
    _sharded_mode_stack,
    _stack_call,
    _tuned_cfg,
    make_planned_ttmc,
)
from ..kernels.ref import ttmc_ref
from ..kernels.ttm import kron_cols, ttmc_blocked
from ..kernels.workspace import PlannedWorkspace, ShardedWorkspace, plan_stream

__all__ = [
    "TuckerState",
    "tucker_hooi",
    "PlannedTucker",
    "make_planned_tucker",
    "ShardedPlannedTucker",
    "make_sharded_planned_tucker",
    "init_tucker_factors",
    "core_fit_value",
]


@dataclasses.dataclass
class TuckerState:
    factors: list[torch.Tensor]  # one (I_m, R_m) per mode, orthonormal columns
    core: torch.Tensor  # (R_0, ..., R_{N-1}) in natural mode order
    fit_history: list[float]

    @property
    def core_ranks(self) -> tuple[int, ...]:
        return tuple(int(s) for s in self.core.shape)


def _validated_core_ranks(st: SparseTensor, core_ranks: Sequence[int]) -> tuple[int, ...]:
    cr = tuple(int(r) for r in core_ranks)
    if len(cr) != st.nmodes:
        raise ValueError(f"core_ranks has {len(cr)} entries for a {st.nmodes}-mode tensor")
    for m, (r, s) in enumerate(zip(cr, st.shape)):
        if not 1 <= r <= s:
            raise ValueError(f"core rank {r} for mode {m} out of range [1, {s}] (mode length)")
        others = math.prod(cr[k] for k in range(len(cr)) if k != m)
        if r > others:
            raise ValueError(
                f"core rank {r} for mode {m} exceeds the product of the other ranks "
                f"({others}): the mode-{m} unfolding of the core cannot have full row rank")
    return cr


def init_tucker_factors(shape: Sequence[int], core_ranks: Sequence[int], *, seed: int,
                        device: torch.device) -> list[torch.Tensor]:
    """Random orthonormal factors (reduced QR of a Gaussian drawn from a
    `torch.Generator(device).manual_seed(seed)`), one (I_m, R_m) per mode:
    HOOI's fit formula assumes orthonormal columns from the first iteration.
    These numbers differ from the reference's `jax.random` draws for the same
    seed; parity with the reference needs its factors passed as
    `init_factors`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.linalg.qr(torch.randn((int(s), int(r)), generator=gen, device=device))[0]
            for s, r in zip(shape, core_ranks)]


def _factor_from_unfolding(y: torch.Tensor, r: int) -> torch.Tensor:
    """Top-r left singular vectors of the unfolding y (I_n, P) via `eigh` of
    the (P, P) Gram.  Columns whose singular value falls below 1e-7 of the
    largest are zeroed rather than divided by ~0; HOOI only uses the
    spanned subspace.

    A non-finite unfolding gives a NaN factor, as the reference's `eigh`
    does, where torch's would raise: `eigh` sees the identity in its place
    (no host sync decides it), and the result is replaced by NaN, so the
    fit turns NaN and the drive loop's guards see it."""
    gram = y.T @ y
    finite = torch.isfinite(gram).all()
    w, v = torch.linalg.eigh(torch.where(finite, gram, torch.eye(gram.shape[0], dtype=gram.dtype,
                                                                   device=gram.device)))
    top_v = v.flip(1)[:, :r]  # eigenvalues ascend
    sigma = torch.sqrt(torch.clamp(w.flip(0)[:r], min=0.0))
    thresh = torch.clamp(sigma[0], min=1e-30) * 1e-7
    inv = torch.where(sigma > thresh, 1.0 / torch.maximum(sigma, thresh), torch.zeros_like(sigma))
    return torch.where(finite, y @ (top_v * inv[None, :]), torch.nan)


def _core_from_unfolding(y: torch.Tensor, u: torch.Tensor, mode: int,
                         core_ranks: tuple[int, ...]) -> torch.Tensor:
    """Fold U^(mode)^T Y_(mode) back into the (R_0, ..., R_{N-1}) core in
    natural mode order (Y's columns are row-major over ascending input
    mode)."""
    nmodes = len(core_ranks)
    in_modes = tuple(m for m in range(nmodes) if m != mode)
    core = (u.T @ y).reshape((core_ranks[mode],) + tuple(core_ranks[m] for m in in_modes))
    axes = (mode,) + in_modes  # axes[k] = the tensor mode of core axis k
    return core.permute(tuple(axes.index(m) for m in range(nmodes)))


def core_fit_value(core: torch.Tensor, norm_x_sq: torch.Tensor) -> torch.Tensor:
    """fit = 1 - ||X - X_hat|| / ||X||.  With orthonormal factors,
    ||X - X_hat||^2 = ||X||^2 - ||G||^2: no pass over the non-zeros."""
    resid_sq = torch.clamp(norm_x_sq - torch.sum(core * core), min=0.0)
    return 1.0 - torch.sqrt(resid_sq) / torch.sqrt(norm_x_sq)


@dataclasses.dataclass
class PlannedTucker(PlannedWorkspace):
    """Per-mode plans driving the whole HOOI loop: one `PlannedTTMC` per
    output mode, built once; the drive loop and padding (each mode to
    rank_padded(R_m)) come from `PlannedWorkspace`, this class supplies the
    HOOI sweep."""

    ops: dict[int, PlannedTTMC]
    shape: tuple[int, ...]
    core_ranks: tuple[int, ...]

    @property
    def lane_ranks(self) -> tuple[int, ...]:
        return self.core_ranks

    @property
    def device(self) -> torch.device:
        return self.ops[0].plan.device

    def plan_for(self, mode: int):
        return self.ops[mode].plan

    def _geoms(self) -> dict:
        return {m: op.plan for m, op in self.ops.items()}

    def smem_model_bytes(self, spec: GPUSpec = GPUSpec()) -> int:
        """Shared memory per CTA of the widest mode's TTMc launch."""
        return max(op.cfg.ttmc_launch(spec, op.in_ranks).smem_bytes for op in self.ops.values())

    def pms_estimates(self, spec: GPUSpec | str = GPUSpec()) -> dict:
        """Exact per-mode TTMc PMS estimates from the built plans."""
        return {m: predict_ttmc(op.plan, self.core_ranks, op.cfg, spec) for m, op in self.ops.items()}

    def sweep(self, facs, norm_x_sq, *, first: bool = False):
        """One HOOI iteration in padded space.

        Each mode's new factor is written IN PLACE into the true block of
        its padded tensor (padding rows and lanes stay exactly 0, so the
        next mode's kernel gathers zeros there).  `norm_x_sq`: ||X||_F^2 as
        a device scalar.  `first` is taken for the drive loop and ignored:
        HOOI has no first-iteration convention.  Returns (padded factors,
        core, fit)."""
        shape, cr = self.shape, self.core_ranks
        facs = tuple(facs)
        y = None
        for m in range(self.nmodes):
            op = self.ops[m]
            p = op.plan
            in_facs = [facs[im][: p.in_rows[n]] for n, im in enumerate(p.in_modes)]
            y = ttmc_blocked(p, in_facs, op.in_ranks)[: shape[m], : op.out_cols]
            facs[m][: shape[m], : cr[m]] = _factor_from_unfolding(y, cr[m])
        last = self.nmodes - 1
        core = _core_from_unfolding(y, facs[last][: shape[last], : cr[last]], last, cr)
        return facs, core, core_fit_value(core, norm_x_sq)

    def _build_fallback_sweep(self):
        """The "fallback" guard policy's target: the same HOOI iteration with
        each mode's kernel replaced by `ttmc_ref`, on the same padded
        factors, written in place.  The sweep takes no stream, so the
        stream is mode 0's plan read back as COO (`plan_stream`; padding
        slots have value 0).  Launches no kernel."""
        idx, val = plan_stream(self.ops[0].plan)
        shape, cr, nmodes = self.shape, self.core_ranks, self.nmodes

        def sweep(facs, norm_x_sq, *, it: int):
            facs = tuple(facs)
            y = None
            for m in range(nmodes):
                true = [f[:s, :r] for f, s, r in zip(facs, shape, cr)]
                y = ttmc_ref(idx, val, true, m, shape[m])
                facs[m][: shape[m], : cr[m]] = _factor_from_unfolding(y, cr[m])
            last = nmodes - 1
            core = _core_from_unfolding(y, facs[last][: shape[last], : cr[last]], last, cr)
            return facs, core, core_fit_value(core, norm_x_sq)

        return sweep


def make_planned_tucker(
    st: SparseTensor,
    core_ranks: Sequence[int],
    *,
    cfg: MemoryControllerConfig | None = None,
    auto_tune: bool | str = False,
    spec: GPUSpec | str = GPUSpec(),
    device: str | torch.device | None = None,
) -> PlannedTucker:
    """Build the HOOI workspace: one TTMc plan per output mode on `device`
    (CUDA unless given), all with `cfg` (or the default), or each at the
    PMS's pick for the TTMc kernel with auto_tune=True or "cached"."""
    cr = _validated_core_ranks(st, core_ranks)
    device = resolve_device(device)
    ops = {m: make_planned_ttmc(st, m, cr, cfg=cfg, auto_tune=auto_tune, spec=spec, device=device)
           for m in range(st.nmodes)}
    return PlannedTucker(ops=ops, shape=st.shape, core_ranks=cr)


@dataclasses.dataclass
class ShardedPlannedTucker(ShardedWorkspace):
    """The HOOI loop on the sharded planned path: the TTM-chain mirror of
    `ShardedPlannedCPALS` (the same partitions and shard stacks, the TTMc
    kernel once per shard, one reduction per mode, the factor updated on
    the first shard's device and copied to the others).  The fit needs no
    stream: the core comes from the last mode's reduced unfolding."""

    stacks: dict
    dist: object  # ShardingPlan
    shape: tuple[int, ...]
    core_ranks: tuple[int, ...]
    cfgs: dict

    @property
    def lane_ranks(self) -> tuple[int, ...]:
        return self.core_ranks

    def in_ranks(self, mode: int) -> tuple[int, ...]:
        return tuple(self.core_ranks[im] for im in self.stacks[mode].in_modes)

    def sweep(self, facs, norm_x_sq, *, first: bool = False):
        """One HOOI iteration in padded space: `PlannedTucker.sweep` with
        each mode's TTMc launched once per shard and reduced.  Returns
        (padded factors, core, fit)."""
        shape, cr = self.shape, self.core_ranks
        facs = tuple(facs)
        reps = Replicas(facs, self.dist.devices)
        y = None
        for m in range(self.nmodes):
            in_ranks = self.in_ranks(m)
            y = reduce_partials(_stack_call(self.stacks[m], ttmc_blocked, reps, in_ranks))
            y = y[: shape[m], : kron_cols(in_ranks)]
            facs[m][: shape[m], : cr[m]] = _factor_from_unfolding(y, cr[m])
            reps.refresh(m)
        last = self.nmodes - 1
        core = _core_from_unfolding(y, facs[last][: shape[last], : cr[last]], last, cr)
        return facs, core, core_fit_value(core, norm_x_sq)


def make_sharded_planned_tucker(
    st: SparseTensor,
    core_ranks: Sequence[int],
    *,
    dist=None,
    devices=None,
    cfg: MemoryControllerConfig | None = None,
    auto_tune: bool | str = False,
    spec: GPUSpec | str = GPUSpec(),
) -> ShardedPlannedTucker:
    """Build the sharded HOOI workspace: one partition and shard stack per
    output mode, on `dist` or `shard_plan(devices)`; with auto_tune each
    mode's configuration is the sharded PMS's pick for the TTMc kernel."""
    cr = _validated_core_ranks(st, core_ranks)
    dist = _resolve_dist(dist, devices)
    stacks: dict[int, _ShardStack] = {}
    cfgs: dict[int, MemoryControllerConfig] = {}
    for m in range(st.nmodes):
        cfgs[m] = _tuned_cfg(st, m, cr, dist.dp_size(), cfg, auto_tune, spec, kernel="ttmc")
        _, stacks[m] = _sharded_mode_stack(st, m, cfgs[m], dist, "ttmc")
    return ShardedPlannedTucker(stacks=stacks, dist=dist, shape=st.shape, core_ranks=cr, cfgs=cfgs)


def tucker_hooi(
    st: SparseTensor,
    core_ranks: Sequence[int],
    *,
    iters: int = 10,
    method: str = "pallas",
    seed: int = 0,
    tol: float | None = None,
    init_factors: Sequence | None = None,
    planned: PlannedTucker | None = None,
    auto_tune: bool | str = False,
    spec: GPUSpec | str = "default",
    cfg: MemoryControllerConfig | None = None,
    device: str | torch.device | None = None,
    devices=None,
    dist=None,
    verbose: bool = False,
    guards=None,
    checkpoint_every: int | None = None,
    checkpoint_path=None,
) -> TuckerState:
    """Run sparse Tucker HOOI.

    method: 'pallas' (the name the reference gives its planned path): a
      `PlannedTucker` workspace is built once (one device-resident BlockPlan
      per output mode) and every TTMc runs through the TTMc kernel;
      'pallas_sharded': the sharded planned path
      (`make_sharded_planned_tucker`, placed by `devices=` / `dist=` as in
      `cp_als`); 'reference' — `ttmc_ref` on the raw COO stream.
    init_factors: one (I_m, R_m) orthonormal array or tensor per mode.
      Without it `init_tucker_factors` draws them from a torch generator
      seeded with `seed`; these numbers differ from the reference's
      `jax.random` draws for the same seed.
    planned: a prebuilt `PlannedTucker` (`make_planned_tucker`, which also
      takes the plan geometry), or `ShardedPlannedTucker` for
      'pallas_sharded', to reuse its plans across calls.
    auto_tune / spec / cfg: the workspace's plan geometry when `planned` is
      not given: `cfg` for every mode, or the PMS's pick per mode for the
      TTMc kernel (auto_tune=True; "cached" keeps the winners on disk).
    device: CUDA unless the caller passes one (raises if no GPU is present).
    guards / checkpoint_every / checkpoint_path: the planned drive loop's
      resilience surface (`repro_torch.resilience`; see `cp_als`).
      The planned paths only.
    """
    cr = _validated_core_ranks(st, core_ranks)
    if method not in ("pallas", "pallas_sharded", "reference"):
        raise ValueError(f"unknown method {method!r}: expected 'pallas', 'pallas_sharded' or "
                         f"'reference'")
    check_planned_method(method, planned, devices, dist)
    check_drive_extras(method, guards, checkpoint_every, checkpoint_path)
    if method == "pallas_sharded":
        if device is not None:
            raise ValueError("method='pallas_sharded' places its shards by devices=/dist=; "
                             "device= would be silently ignored")
        if planned is None:
            planned = make_sharded_planned_tucker(st, cr, dist=dist, devices=devices, cfg=cfg,
                                                  auto_tune=auto_tune, spec=spec)
        else:
            check_workspace(planned, ShardedPlannedTucker, {"shape": st.shape, "core_ranks": cr},
                            method=method, devices=devices, dist=dist)
        device = planned.device
    else:
        device = resolve_device(device)
        if planned is not None:
            check_workspace(planned, PlannedTucker, {"shape": st.shape, "core_ranks": cr}, device,
                            method=method)
    if init_factors is None:
        factors = init_tucker_factors(st.shape, cr, seed=seed, device=device)
    else:
        factors = given_factors(init_factors, list(zip(st.shape, cr)), device)
    norm_x_sq = torch.tensor(norm_sq(st), dtype=torch.float32, device=device)

    if method in ("pallas", "pallas_sharded"):
        if planned is None:
            planned = make_planned_tucker(st, cr, cfg=cfg, auto_tune=auto_tune, spec=spec,
                                          device=device)
        factors, core, fits = planned.drive(
            factors, (norm_x_sq,), iters=iters, tol=tol, verbose=verbose, label="tucker_hooi",
            guards=guards, checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path)
        return TuckerState(factors=factors, core=core, fit_history=fits)

    idx, val = to_device(st, device)
    fits: list[float] = []
    core = None
    last = st.nmodes - 1
    for it in range(iters):
        y = None
        for m in range(st.nmodes):
            y = ttmc_ref(idx, val, factors, m, st.shape[m])
            factors[m] = _factor_from_unfolding(y, cr[m])
        core = _core_from_unfolding(y, factors[last], last, cr)
        if finish_iter(fits, core_fit_value(core, norm_x_sq), it, tol, verbose, "tucker_hooi"):
            break
    return TuckerState(factors=factors, core=core, fit_history=fits)
