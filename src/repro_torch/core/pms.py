"""Performance Model Simulator (paper Sec. 5.3) for the port's Hopper kernels.

Counterpart of the single-device half of `repro.core.pms`.  Given tensor
statistics (or a built BlockPlan) and a MemoryControllerConfig, it prices
one output mode's kernel with a roofline and searches the controller's
parameter space under the kernel's shared-memory limit, so a plan is built
only for the configuration that wins.

Model (per output mode; S the plan's slots, nnz its real ones):
  t_stream  = S * (value + (N-1+1) index bytes) / hbm_bw
  t_reread  = (row parts * column slices - 1) * t_stream
  t_factor  = sum_n in_rows_n * lanes_n * value bytes / hbm_bw
  t_out     = fills["A"] * tile_i * out_lanes * value bytes / hbm_bw
  t_mem     = t_stream + t_reread + t_factor + t_out        (HBM)
  t_gather  = nnz * sum_n sectors(lanes_n) / l2_bw
  t_flush   = row runs * sectors(out_lanes) / l2_bw
  t_l2      = t_gather + t_flush                             (L2)
  t_compute = nnz * flops per non-zero / peak_flops_f32
  t_total   = max(t_mem + t_l2, t_compute)
              / (occupancy * step share * wave share)

with sectors(w) the 32-byte sectors of w float32 lanes.  What depends only
on the layout is the reference's, to the bit: the plan's `nblocks`, tile
fills and padding, the balls-in-bins occupancy estimate
(`_analytic_layout`), the stream term, the candidate grid and its order.
Seven things differ on purpose, because the kernels differ:

  1. Lane padding.  A factor row is `rank_padded(R)` lanes, R rounded up to
     a multiple of 4 (kernels/mttkrp.py), and a TTMc output row
     `cols_padded(prod R)` (kernels/ttm.py), where the reference pads both
     to 128 TPU lanes; the TT-core kernel reads and writes the true
     rl * rr lanes of each interface and of its output.
  2. Compute.  The CUDA kernels skip padding slots and run on the CUDA
     cores, so t_compute counts their own flops per real non-zero, as
     `chip_smoke.py`'s bounds do: N per non-zero and padded column for
     MTTKRP; the Kronecker chain's multiplies plus one add per output
     column for TTMc; for TT-core, a multiply-add per matrix element of
     each chain step after a chain's first, rl_m multiplies for the value
     and a multiply and an add per output column.  The reference's MXU
     one-hot segment product (tile_i x blk x lanes per block) has no
     counterpart.
  3. Fit.  A candidate is kept when its kernel's shared memory per CTA fits
     `GPUSpec.smem_per_block` (`MemoryControllerConfig.*_launch`), not the
     VMEM budget; each estimate reports that shared memory and the row
     parts and column slices the geometry forces.
  4. Re-reads.  Each row part and column slice is a CTA of its own that
     reads its block range's stream and sorts it again (blocked.cuh), so
     the stream is priced once per CTA of a range (`t_reread`).  The
     reference's kernel reads its stream once.  On an H100 at NELL-2 size
     the TT-core kernel's middle mode at (16, 16) took 62-106 ms at tile_i
     1,024 (16 row parts) against 29 ms at 256 (4 parts), though the
     one-pass stream was smaller there.
  5. Shares of the card.  The roofline's rates need the CTAs per SM the
     kernel is built for (`__launch_bounds__`: 4, or 2 for wide rows);
     where a CTA's shared memory leaves fewer, t_total is divided by that
     share (`occupancy`).  The TT-core kernel's steps never span plan
     blocks, so blocks of fewer slots than a step holds leave threads
     idle, and t_total is divided by the busy share (`step_share`).  Both
     come from the kernels' layouts (`MemoryControllerConfig.*_launch`).
     At NELL-2 size the TT-core kernel's first mode took 17-23 ms at tile
     1,024 (2 CTAs per SM) against 12.9 ms at 256 (4), and both TT modes
     timed took 23-24 ms at blk 128 against 17 ms at blk 256.
  6. What the kernels read and write.  The reference's kernel fetches a
     whole input factor tile into VMEM each time a block changes tile
     (fills * tile * lanes bytes), so large tiles save fetches.  The CUDA
     kernels fetch no tile: every real slot gathers its N-1 input rows
     through L2, in 32-byte sectors (`t_gather`, the same at every
     geometry), each input factor comes from HBM once (`t_factor`), and
     the rows summed in registers reach the output with atomics once per
     row and sort unit (`t_flush`): a 2,048-slot chunk for MTTKRP, an
     8,192-slot chunk for TTMc, a block range for TT-core.  Row runs are
     the balls-in-bins count of a unit's real slots over a tile's rows,
     units * tile_i * (1 - exp(-real slots a unit / tile_i)), on the
     plan's padding (exact) or the occupancy model's (analytic).  The
     HBM and L2 terms add: a CTA reads its stream, then gathers its rows.
     The fill-priced term ranked TTMc and TT-core mode 0 backwards on the
     card (Spearman -0.77 each, `chip_smoke.py` phase i on an H100): it
     rewarded tiles the kernels get nothing from.
  7. The grid's last wave.  `launch_ranges` (blocked.cuh) runs one CTA per
     (block range of at most 64 blocks, part, slice), at least a wave of
     them; with W waves of the SMs' resident CTAs the last is half idle on
     average, so t_total is divided by W / max(1, W + 1/2) (`wave_share`).
     Blocks of 1,024 slots leave 2.3 waves at NELL-2 size, where the
     MTTKRP kernel took 2.36 ms against 1.95 at blk 256 on the same
     number of slots (`scripts/torch_pms_probe.py`, "NVIDIA H100 80GB HBM3,
     700.00 W").

The sharded half (`predict_sharded`, `search_sharded`) prices each shard
of `dist.sharding.partition_stream`'s split alone, with the same model, and
scores a configuration by its slowest shard: the reference's makespan.  On
one card the port runs its shards one after another, so a sharded sweep
there takes about the sum of its shards; the makespan is what a machine
with a card per shard would wait for, and what ranks the configurations.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Sequence

import torch

from ..device import resolve_device
from ..kernels.mttkrp import rank_padded
from ..kernels.ttm import cols_padded
from .coo import SparseTensor
from .hypergraph import HypergraphStats, stats as hg_stats
from .memctrl import (
    _MTTKRP_SORT_SLOTS,
    _RANGE_BLOCKS,
    _TTMC_SORT_SLOTS,
    CacheEngineConfig,
    DMAEngineConfig,
    GPUSpec,
    KernelLaunch,
    MemoryControllerConfig,
)
from .remap import BlockPlan, plan_blocks

_SECTOR = 32  # bytes an L2 sector holds: the unit of a gather

__all__ = [
    "PMSEstimate",
    "predict_from_plan",
    "predict_analytic",
    "predict_ttmc",
    "predict_ttmc_analytic",
    "predict_tt",
    "predict_tt_analytic",
    "resolve_spec",
    "search",
    "ShardedPMSEstimate",
    "predict_sharded",
    "search_sharded",
    "DEFAULT_TILE_CHOICES",
    "DEFAULT_BLK_CHOICES",
]


@dataclasses.dataclass(frozen=True)
class PMSEstimate:
    cfg: MemoryControllerConfig
    t_stream: float
    t_factor: float
    t_out: float
    t_compute: float
    smem_bytes: int
    nblocks: int
    padding_fraction: float
    row_parts: int = 1
    col_slices: int = 1
    t_reread: float = 0.0
    occupancy: float = 1.0
    step_share: float = 1.0
    t_gather: float = 0.0
    t_flush: float = 0.0
    wave_share: float = 1.0

    @property
    def t_mem(self) -> float:
        """The HBM terms: bytes over `hbm_bw`."""
        return self.t_stream + self.t_reread + self.t_factor + self.t_out

    @property
    def t_l2(self) -> float:
        """The L2 terms: bytes over `l2_bw`."""
        return self.t_gather + self.t_flush

    @property
    def t_total(self) -> float:
        return (max(self.t_mem + self.t_l2, self.t_compute)
                / (self.occupancy * self.step_share * self.wave_share))

    @property
    def bottleneck(self) -> str:
        return "memory" if self.t_mem + self.t_l2 >= self.t_compute else "compute"


def resolve_spec(spec) -> GPUSpec:
    """Resolve a `spec=` argument: a `GPUSpec` passes through, "default" is
    the data-sheet `GPUSpec()`, and "measured" is this backend's fitted
    spec from the autotune cache (`repro_torch.tune`), calibrated on a
    miss."""
    if isinstance(spec, GPUSpec):
        return spec
    from ..tune import resolve_spec as _tune_resolve  # deferred: tune -> pms

    return _tune_resolve(spec)


def _count_configs(kernel: str, n: int, sharded: bool = False) -> None:
    """Count the configurations a search priced (``pms.configs_evaluated``):
    zero on a warm autotune-cache hit."""
    from ..obs import metrics as _metrics

    label = "true" if sharded else "false"
    _metrics.counter("pms.configs_evaluated", kernel=kernel, sharded=label).inc(n)
    _metrics.counter("pms.searches", kernel=kernel, sharded=label).inc()


@dataclasses.dataclass(frozen=True)
class _KernelModel:
    """One kernel's width-dependent terms: lanes of each input factor and of
    the output row, flops per real non-zero, its launch at a config, and
    the slots of its sort unit, whose rows reach the output once each
    (None: a block range)."""

    in_lanes: tuple[int, ...]
    out_lanes: int
    flops_per_nnz: int
    launch: Callable[[MemoryControllerConfig, GPUSpec], KernelLaunch]
    flush_slots: int | None = None


def _mttkrp_model(nmodes: int, rank: int) -> _KernelModel:
    rp = rank_padded(rank)
    n_in = nmodes - 1
    return _KernelModel((rp,) * n_in, rp, nmodes * rp,
                        lambda cfg, spec: cfg.mttkrp_launch(spec, rp, n_in), _MTTKRP_SORT_SLOTS)


def _ttmc_in_ranks(core_ranks: Sequence[int], mode: int) -> tuple[int, ...]:
    return tuple(int(r) for m, r in enumerate(core_ranks) if m != mode)


def _ttmc_model(in_ranks: tuple[int, ...]) -> _KernelModel:
    ncols = math.prod(in_ranks)
    chain = sum(math.prod(in_ranks[: k + 1]) for k in range(len(in_ranks)))
    return _KernelModel(tuple(rank_padded(r) for r in in_ranks), cols_padded(ncols),
                        chain + ncols, lambda cfg, spec: cfg.ttmc_launch(spec, in_ranks),
                        _TTMC_SORT_SLOTS)


def _tt_pairs(
    core_ranks: Sequence[int], nmodes: int, mode: int
) -> tuple[tuple[tuple[int, int], ...], tuple[int, int]]:
    """Per-core (rl, rr) bond pairs from the N-1 interior TT ranks, split
    into the input pairs (ascending in_modes order: the first `mode` of
    them chain from the left) and the output mode's own pair."""
    bounds = (1,) + tuple(int(r) for r in core_ranks) + (1,)
    pairs = tuple((bounds[k], bounds[k + 1]) for k in range(nmodes))
    return tuple(p for m, p in enumerate(pairs) if m != mode), pairs[mode]


def _tt_model(in_pairs: tuple[tuple[int, int], ...], out_pair: tuple[int, int],
              n_left: int) -> _KernelModel:
    rl_m, rr_m = out_pair
    left, right = in_pairs[:n_left], in_pairs[n_left:]
    chain = sum(2 * a * b for a, b in left[1:]) + sum(2 * a * b for a, b in right[:-1])
    return _KernelModel(tuple(a * b for a, b in in_pairs), rl_m * rr_m,
                        chain + rl_m + 2 * rl_m * rr_m,
                        lambda cfg, spec: cfg.tt_launch(spec, in_pairs, n_left))


def _sectors(lanes: int, value_bytes: int) -> int:
    """Bytes of the 32-byte sectors that hold `lanes` values."""
    return -(-lanes * value_bytes // _SECTOR) * _SECTOR


def _estimate(
    model: _KernelModel,
    cfg: MemoryControllerConfig,
    spec: GPUSpec,
    *,
    nblocks: int,
    fills: dict[str, int],
    padding: float,
    nnz: int,
    tile_i: int,
    in_tiles: tuple[int, ...],
    in_rows: tuple[int, ...],
    blk: int,
) -> PMSEstimate:
    """The roofline terms at a layout (a built plan's, or the occupancy
    model's) and the kernel's launch at `cfg`."""
    r = cfg.remapper
    n_in = len(in_tiles)
    slots = nblocks * blk
    stream_bytes = slots * (r.value_bytes + (n_in + 1) * r.index_bytes)
    factor_bytes = sum(rows * w for rows, w in zip(in_rows, model.in_lanes)) * r.value_bytes
    out_bytes = fills["A"] * tile_i * model.out_lanes * r.value_bytes
    gather_bytes = nnz * sum(_sectors(w, r.value_bytes) for w in model.in_lanes)
    # Row runs: each sort unit's real slots over its tile's rows.
    unit = min(model.flush_slots or _RANGE_BLOCKS * blk, _RANGE_BLOCKS * blk, slots)
    real = unit * (1.0 - padding)
    runs = (nnz / real) * tile_i * -math.expm1(-real / tile_i) if real > 0 else 0.0
    flush_bytes = runs * _sectors(model.out_lanes, r.value_bytes)
    launch = model.launch(cfg, spec)
    held = spec.sms * launch.ctas_per_sm
    ranges = min(max(held // launch.slices, -(-nblocks // _RANGE_BLOCKS)), nblocks)
    waves = ranges * launch.slices / held
    return PMSEstimate(
        cfg=cfg,
        t_stream=stream_bytes / spec.hbm_bw,
        t_reread=(launch.slices - 1) * stream_bytes / spec.hbm_bw,
        t_factor=factor_bytes / spec.hbm_bw,
        t_out=out_bytes / spec.hbm_bw,
        t_compute=nnz * model.flops_per_nnz / spec.peak_flops_f32,
        smem_bytes=launch.smem_bytes,
        nblocks=nblocks,
        padding_fraction=padding,
        row_parts=launch.row_parts,
        col_slices=launch.col_slices,
        occupancy=launch.occupancy,
        step_share=launch.step_share,
        t_gather=gather_bytes / spec.l2_bw,
        t_flush=flush_bytes / spec.l2_bw,
        wave_share=waves / max(1.0, waves + 0.5),
    )


def _from_plan(model: _KernelModel, plan: BlockPlan, cfg: MemoryControllerConfig,
               spec) -> PMSEstimate:
    """Exact terms: the plan's own geometry, fills and padding."""
    return _estimate(model, cfg, resolve_spec(spec), nblocks=plan.nblocks, fills=plan.tile_fills(),
                     padding=plan.padding_fraction(), nnz=plan.nnz, tile_i=plan.tile_i,
                     in_tiles=plan.in_tiles, in_rows=plan.in_rows, blk=plan.blk)


def _expected_occupied(bins: float, balls: float) -> float:
    """E[# occupied bins] for `balls` uniform balls in `bins` bins."""
    if bins <= 1:
        return 1.0
    return bins * (1.0 - math.exp(-balls / bins))


def _analytic_layout(
    hs: HypergraphStats, mode: int, cfg: MemoryControllerConfig
) -> tuple[int, dict[str, int], float]:
    """Balls-in-bins occupancy estimate of the BlockPlan geometry, the
    reference's to the bit (the group structure depends only on the
    layout).  Returns (nblocks, fills, padding)."""
    in_modes = [m for m in range(hs.nmodes) if m != mode]
    n_in = len(in_modes)
    c, d = cfg.cache, cfg.dma
    in_tiles = c.input_tiles(n_in)
    n_it = math.ceil(hs.shape[mode] / c.tile_i)
    n_ins = [math.ceil(hs.shape[m] / t) for m, t in zip(in_modes, in_tiles)]

    groups = _expected_occupied(n_it * math.prod(n_ins), hs.nnz)
    # each occupied tile-id group costs >= 1 block; remaining nnz fill blocks
    nblocks = int(groups + hs.nnz / d.blk)
    fills = {"A": _expected_occupied(n_it, hs.nnz)}
    for n in range(n_in):
        fills[chr(ord("B") + n)] = groups  # each id changes at most once/group
    fills = {k: int(max(1, v)) for k, v in fills.items()}
    padding = max(0.0, 1.0 - hs.nnz / float(nblocks * d.blk))
    return nblocks, fills, padding


def _analytic(model: _KernelModel, hs: HypergraphStats, mode: int,
              cfg: MemoryControllerConfig, spec) -> PMSEstimate:
    """Terms from the occupancy model: no plan is built."""
    nblocks, fills, padding = _analytic_layout(hs, mode, cfg)
    in_tiles = cfg.cache.input_tiles(hs.nmodes - 1)
    in_modes = [m for m in range(hs.nmodes) if m != mode]
    in_rows = tuple(-(-hs.shape[m] // t) * t for m, t in zip(in_modes, in_tiles))
    return _estimate(model, cfg, resolve_spec(spec), nblocks=nblocks, fills=fills,
                     padding=padding, nnz=hs.nnz, tile_i=cfg.cache.tile_i,
                     in_tiles=in_tiles, in_rows=in_rows, blk=cfg.dma.blk)


def predict_from_plan(plan: BlockPlan, rank: int, cfg: MemoryControllerConfig,
                      spec: GPUSpec | str = GPUSpec()) -> PMSEstimate:
    """Exact MTTKRP terms from a built memory layout (measured fills and
    padding)."""
    return _from_plan(_mttkrp_model(plan.n_in + 1, rank), plan, cfg, spec)


def predict_analytic(hs: HypergraphStats, mode: int, rank: int, cfg: MemoryControllerConfig,
                     spec: GPUSpec | str = GPUSpec()) -> PMSEstimate:
    """Analytic MTTKRP terms: no plan construction.  Skewed tensors have
    fewer, hotter groups than the uniform occupancy model assumes, so it
    overestimates their blocks and fills."""
    return _analytic(_mttkrp_model(hs.nmodes, rank), hs, mode, cfg, spec)


def predict_ttmc(plan: BlockPlan, core_ranks: Sequence[int], cfg: MemoryControllerConfig,
                 spec: GPUSpec | str = GPUSpec()) -> PMSEstimate:
    """Exact TTMc terms from a built memory layout.  `core_ranks` is the
    full N-tuple of Tucker core ranks."""
    in_ranks = tuple(int(core_ranks[m]) for m in plan.in_modes)
    return _from_plan(_ttmc_model(in_ranks), plan, cfg, spec)


def predict_ttmc_analytic(hs: HypergraphStats, mode: int, core_ranks: Sequence[int],
                          cfg: MemoryControllerConfig,
                          spec: GPUSpec | str = GPUSpec()) -> PMSEstimate:
    """Analytic TTMc terms: the shared occupancy model."""
    return _analytic(_ttmc_model(_ttmc_in_ranks(core_ranks, mode)), hs, mode, cfg, spec)


def predict_tt(plan: BlockPlan, core_ranks: Sequence[int], cfg: MemoryControllerConfig,
               spec: GPUSpec | str = GPUSpec()) -> PMSEstimate:
    """Exact TT-core terms from a built memory layout.  `core_ranks` are the
    N-1 interior TT bond ranks."""
    in_pairs, out_pair = _tt_pairs(core_ranks, plan.n_in + 1, plan.mode)
    return _from_plan(_tt_model(in_pairs, out_pair, plan.mode), plan, cfg, spec)


def predict_tt_analytic(hs: HypergraphStats, mode: int, core_ranks: Sequence[int],
                        cfg: MemoryControllerConfig,
                        spec: GPUSpec | str = GPUSpec()) -> PMSEstimate:
    """Analytic TT-core terms: the shared occupancy model."""
    in_pairs, out_pair = _tt_pairs(core_ranks, hs.nmodes, mode)
    return _analytic(_tt_model(in_pairs, out_pair, mode), hs, mode, cfg, spec)


DEFAULT_TILE_CHOICES: tuple[int, ...] = (128, 256, 512, 1024)
DEFAULT_BLK_CHOICES: tuple[int, ...] = (128, 256, 512, 1024)


def _kernel_model(kernel: str, rank: int, core_ranks, nmodes: int, mode: int) -> _KernelModel:
    """Check the arguments of a per-kernel entry point (the reference's
    contract) and return the kernel's model at this mode."""
    if kernel not in ("mttkrp", "ttmc", "tt"):
        raise ValueError(f"unknown kernel {kernel!r}: expected 'mttkrp', 'ttmc' or 'tt'")
    if kernel == "ttmc":
        if core_ranks is None:
            raise ValueError("kernel='ttmc' requires core_ranks (the full N-tuple)")
        if len(core_ranks) != nmodes:
            raise ValueError(
                f"core_ranks has {len(core_ranks)} entries for a {nmodes}-mode tensor "
                f"(pass the full N-tuple, not the N-1 input ranks)")
        return _ttmc_model(_ttmc_in_ranks(core_ranks, mode))
    if kernel == "tt":
        if core_ranks is None:
            raise ValueError("kernel='tt' requires core_ranks (the N-1 interior TT ranks)")
        if len(core_ranks) != nmodes - 1:
            raise ValueError(
                f"core_ranks has {len(core_ranks)} entries for a {nmodes}-mode tensor "
                f"(pass the N-1 interior TT ranks, not per-mode ranks)")
        in_pairs, out_pair = _tt_pairs(core_ranks, nmodes, mode)
        return _tt_model(in_pairs, out_pair, mode)
    return _mttkrp_model(nmodes, rank)


def _feasible_configs(model: _KernelModel, spec: GPUSpec, tile_choices: Sequence[int],
                      blk_choices: Sequence[int]):
    """The controller design space in the reference's order, pruned by the
    kernel's shared-memory fit."""
    for ti, tj, tk, blk in itertools.product(tile_choices, tile_choices, tile_choices, blk_choices):
        cfg = MemoryControllerConfig(
            cache=CacheEngineConfig(tile_i=ti, tile_j=tj, tile_k=tk),
            dma=DMAEngineConfig(blk=blk),
        )
        if model.launch(cfg, spec).fits:
            yield cfg


def search(
    st_or_stats: SparseTensor | HypergraphStats,
    mode: int,
    rank: int,
    *,
    spec: GPUSpec | str = GPUSpec(),
    tile_choices: Sequence[int] = DEFAULT_TILE_CHOICES,
    blk_choices: Sequence[int] = DEFAULT_BLK_CHOICES,
    exact: bool = False,
    top_k: int = 5,
    kernel: str = "mttkrp",
    core_ranks: Sequence[int] | None = None,
    device: str | torch.device | None = None,
) -> list[PMSEstimate]:
    """Exhaustive parameter search (paper Sec. 5.3), pruned by the kernel's
    shared-memory fit; the `top_k` best by t_total.  exact=True builds a
    BlockPlan per candidate on `device` (CUDA unless given), one at a
    time; the analytic search builds none and runs on the host.

    kernel: 'mttkrp' (CP-ALS, at `rank`), 'ttmc' (Tucker HOOI, at
    `core_ranks`, the full N-tuple; `rank` is ignored) or 'tt' (TT-ALS, at
    `core_ranks`, the N-1 interior TT bond ranks)."""
    spec = resolve_spec(spec)
    if isinstance(st_or_stats, SparseTensor):
        hs, st = hg_stats(st_or_stats), st_or_stats
    else:
        hs, st = st_or_stats, None
        exact = False
    model = _kernel_model(kernel, rank, core_ranks, hs.nmodes, mode)
    n_in = hs.nmodes - 1
    dev = resolve_device(device) if exact else None

    results: list[PMSEstimate] = []
    for cfg in _feasible_configs(model, spec, tile_choices, blk_choices):
        if exact:
            plan = plan_blocks(st, mode, tile_i=cfg.cache.tile_i, blk=cfg.dma.blk,
                               in_tiles=cfg.cache.input_tiles(n_in), device=dev)
            results.append(_from_plan(model, plan, cfg, spec))
            del plan
        else:
            results.append(_analytic(model, hs, mode, cfg, spec))
    _count_configs(kernel, len(results))
    results.sort(key=lambda e: e.t_total)
    return results[:top_k]


# ---------------------------------------------------------------------------
# The sharded PMS: a configuration scored by its worst shard
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedPMSEstimate:
    """One configuration of the sharded planned path: the stream split as
    `make_sharded_planned_*` splits it, each shard priced alone.  `t_total`
    is the makespan, the slowest shard's time (the reference's semantics):
    with a card per shard the shards run at once.  On one card the port
    runs them one after another, where a sweep takes about the sum
    (`t_sum`).  The reduction's copies and adds are the same for every
    configuration at one rank and are not priced."""

    cfg: MemoryControllerConfig
    per_shard: tuple[PMSEstimate, ...]
    shard_nnz: tuple[int, ...]

    @property
    def nshards(self) -> int:
        return len(self.per_shard)

    @property
    def t_total(self) -> float:
        """The makespan: the slowest shard's time."""
        return max(e.t_total for e in self.per_shard)

    @property
    def t_sum(self) -> float:
        """The shards' times added: one card running them in turn."""
        return sum(e.t_total for e in self.per_shard)

    @property
    def critical_shard(self) -> int:
        """The shard that sets the makespan."""
        ts = [e.t_total for e in self.per_shard]
        return ts.index(max(ts))

    @property
    def smem_bytes(self) -> int:
        """Shared memory per CTA (one configuration: every shard's)."""
        return self.per_shard[0].smem_bytes

    @property
    def imbalance(self) -> float:
        """max / mean shard nnz."""
        from ..dist.sharding import stream_imbalance

        return stream_imbalance(self.shard_nnz)

    @property
    def bottleneck(self) -> str:
        return self.per_shard[self.critical_shard].bottleneck


def _empty_shard_estimate(model: _KernelModel, cfg: MemoryControllerConfig,
                          spec: GPUSpec) -> PMSEstimate:
    """A shard that owns no non-zero: its one all-padding block costs
    nothing against any real shard."""
    launch = model.launch(cfg, spec)
    return PMSEstimate(cfg=cfg, t_stream=0.0, t_factor=0.0, t_out=0.0, t_compute=0.0,
                       smem_bytes=launch.smem_bytes, nblocks=0, padding_fraction=0.0,
                       row_parts=launch.row_parts, col_slices=launch.col_slices,
                       occupancy=launch.occupancy, step_share=launch.step_share)


def _shard_estimate(model: _KernelModel, shard: SparseTensor, hs: HypergraphStats | None,
                    mode: int, cfg: MemoryControllerConfig, spec: GPUSpec, exact: bool,
                    device) -> PMSEstimate:
    if shard.nnz == 0:
        return _empty_shard_estimate(model, cfg, spec)
    if exact:
        plan = plan_blocks(shard, mode, tile_i=cfg.cache.tile_i, blk=cfg.dma.blk,
                           in_tiles=cfg.cache.input_tiles(shard.nmodes - 1), device=device)
        return _from_plan(model, plan, cfg, spec)
    return _analytic(model, hs if hs is not None else hg_stats(shard), mode, cfg, spec)


def predict_sharded(
    st: SparseTensor,
    mode: int,
    rank: int,
    nshards: int,
    cfg: MemoryControllerConfig,
    *,
    spec: GPUSpec | str = GPUSpec(),
    kernel: str = "mttkrp",
    core_ranks: Sequence[int] | None = None,
    exact: bool = True,
    device: str | torch.device | None = None,
) -> ShardedPMSEstimate:
    """The PMS terms of one configuration on the sharded path: the stream
    partitioned as `make_sharded_planned_*` partitions it (balanced nnz,
    tile_i-aligned), each shard priced alone; exact=True builds each
    shard's plan on `device` (CUDA unless given), exact=False takes the
    occupancy model per shard.  `kernel` / `core_ranks` as in `search`."""
    from ..dist.sharding import partition_stream

    spec = resolve_spec(spec)
    model = _kernel_model(kernel, rank, core_ranks, st.nmodes, mode)
    dev = resolve_device(device) if exact else None
    part = partition_stream(st, mode, nshards, tile=cfg.cache.tile_i)
    ests = tuple(_shard_estimate(model, sh, None, mode, cfg, spec, exact, dev)
                 for sh in part.shards)
    return ShardedPMSEstimate(cfg=cfg, per_shard=ests, shard_nnz=part.shard_nnz)


def search_sharded(
    st: SparseTensor,
    mode: int,
    rank: int,
    nshards: int,
    *,
    spec: GPUSpec | str = GPUSpec(),
    tile_choices: Sequence[int] = DEFAULT_TILE_CHOICES,
    blk_choices: Sequence[int] = DEFAULT_BLK_CHOICES,
    exact: bool = False,
    top_k: int = 5,
    kernel: str = "mttkrp",
    core_ranks: Sequence[int] | None = None,
    device: str | torch.device | None = None,
) -> list[ShardedPMSEstimate]:
    """`search` on the sharded path: every configuration whose kernel fits
    shared memory, ranked by its worst shard (a configuration that wins on
    the average shard can lose on the critical one).  The partition and
    each shard's statistics are computed once per tile_i, which is all the
    split depends on."""
    from ..dist.sharding import partition_stream

    spec = resolve_spec(spec)
    model = _kernel_model(kernel, rank, core_ranks, st.nmodes, mode)
    dev = resolve_device(device) if exact else None
    parts: dict[int, tuple] = {}  # tile_i -> (partition, per-shard stats)
    results: list[ShardedPMSEstimate] = []
    for cfg in _feasible_configs(model, spec, tile_choices, blk_choices):
        ti = cfg.cache.tile_i
        if ti not in parts:
            part = partition_stream(st, mode, nshards, tile=ti)
            parts[ti] = (part, [hg_stats(sh) if sh.nnz and not exact else None
                                for sh in part.shards])
        part, sstats = parts[ti]
        ests = tuple(_shard_estimate(model, sh, hs, mode, cfg, spec, exact, dev)
                     for sh, hs in zip(part.shards, sstats))
        results.append(ShardedPMSEstimate(cfg=cfg, per_shard=ests, shard_nnz=part.shard_nnz))
    _count_configs(kernel, len(results), sharded=True)
    results.sort(key=lambda e: e.t_total)
    return results[:top_k]
