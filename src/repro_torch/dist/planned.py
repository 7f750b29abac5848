"""The sharded planned decomposition: counterpart of `repro.dist.planned`.

    Tensor Remapper (core/remap.plan_blocks, per shard)
      -> BlockPlans (one per shard and mode, each on its shard's device)
        -> the CUDA kernels (kernels/csrc), one launch per shard
          -> one reduction of partial factor rows per mode
             (dist/collective.reduce_partials)

`partition_stream` splits the stream per output mode into balanced,
tile-aligned ranges, every shard gets its own BlockPlan on its own device,
and the unchanged kernels run once per shard.  The reference runs its
shards under `shard_map` on D devices of one mesh; here one process drives
them in turn, so D shards may share one card (or the CPU):

  * `cp_als` / `tucker_hooi` / `tt_als(..., method="pallas_sharded",
    devices=D or dist=shard_plan(...))`, or `decompose(...,
    method="pallas_sharded", ...)` for any format;
  * `make_sharded_planned_cp_als` / `_tucker` / `_tt`, workspaces reused
    across calls, and `make_sharded_planned_mttkrp` for one (tensor, mode),
    also reached through `core.mttkrp.mttkrp_sharded(..., method="pallas")`;
  * `shard_plan`, the placement, and `shard_makespan_report`, the shards'
    balance per mode.

The sharded sweeps run in the same `drive` loop as the single-device ones,
so `guards=` and the checkpoints work unchanged, except that the
"fallback" policy has no reference sweep over shard stacks and escalates
to `DecompositionDiverged`.  A dead shard (its plan's values zeroed:
`repro_torch.testing.faults.deaden_shard`) shows as a fit regression,
which the guards catch.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from ..core.loop import DecompositionDiverged, GuardConfig
from ..device import resolve_device
from ..kernels.ops import (
    ShardedPlannedCPALS,
    ShardedPlannedMTTKRP,
    make_sharded_planned_cp_als,
    make_sharded_planned_mttkrp,
)
from ..obs import metrics as _metrics
from ..tt.als import ShardedPlannedTT, make_sharded_planned_tt
from ..tucker.hooi import ShardedPlannedTucker, make_sharded_planned_tucker
from .sharding import ShardingPlan, StreamPartition, partition_stream

__all__ = [
    "shard_plan",
    "partition_stream",
    "StreamPartition",
    "ShardingPlan",
    "ShardedPlannedMTTKRP",
    "ShardedPlannedCPALS",
    "ShardedPlannedTucker",
    "ShardedPlannedTT",
    "make_sharded_planned_mttkrp",
    "make_sharded_planned_cp_als",
    "make_sharded_planned_tucker",
    "make_sharded_planned_tt",
    "shard_makespan_report",
    "GuardConfig",
    "DecompositionDiverged",
]


def shard_plan(devices: int | Sequence[str | torch.device] | None = None) -> ShardingPlan:
    """The placement of the sharded planned path.

    None or an int D: the first D CUDA devices (None: all of them); raises
    where fewer exist, and never falls back to the CPU.  A sequence: those
    devices, in that order, repeats allowed: `["cuda:0"] * 4` runs 4
    shards on one card, `["cpu"] * 4` 4 shards on the CPU (where the
    reference forces a host device count with XLA_FLAGS)."""
    if devices is None or isinstance(devices, int):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if devices is None else int(devices)
        if devices is not None and n < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if n < 1 or n > have:
            raise ValueError(
                f"requested {n if devices is not None else 'all'} CUDA devices but {have} "
                f"{'is' if have == 1 else 'are'} available; to run several shards on fewer "
                f"devices, pass a sequence of devices, e.g. shard_plan(['cuda:0'] * 4) or "
                f"shard_plan(['cpu'] * 4)")
        return ShardingPlan(devices=tuple(torch.device("cuda", d) for d in range(n)))
    devs = tuple(torch.device(d) for d in devices)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in devs:
        if d.type == "cuda" and (have == 0 or (d.index or 0) >= have):
            raise ValueError(f"{d} was requested but torch sees {have} CUDA devices")
    if not devs:
        raise ValueError("a ShardingPlan needs at least one device")
    return ShardingPlan(devices=tuple(resolve_device(d) for d in devs))


def shard_makespan_report(ws: Any) -> dict:
    """The shards' balance per mode of a sharded planned workspace (or a
    `ShardedPlannedMTTKRP`): the reference's report and numbers.

      * `shard_nblocks` / `shard_nnz`: each shard plan's blocks (at least
        1: an empty shard launches one padding block) and non-zeros;
      * `makespan_blocks`: the most blocks any shard walks;
      * `block_imbalance`: max / mean shard blocks (1.0 is a perfect
        balance; on one card per shard, the sweep's slowdown against it);
      * `busy_fraction`: each shard's blocks over the makespan.

    On one card the shards run in turn and the sweep walks the sum of the
    blocks, so the imbalance costs nothing there.  Each mode's imbalance is
    also recorded in `sharded.block_imbalance{mode}` and
    `sharded.nnz_imbalance{mode}`."""
    stacks = getattr(ws, "stacks", None)
    if stacks is None:
        stack = getattr(ws, "stack", None)
        if stack is None:
            raise TypeError(f"{type(ws).__name__} exposes no shard stacks; the makespan report "
                            f"needs a sharded planned workspace")
        stacks = {stack.mode: stack}
    modes = {}
    for m, stack in sorted(stacks.items()):
        nb = [max(1, int(b)) for b in stack.shard_nblocks]
        nnz = [int(z) for z in stack.shard_nnz]
        makespan = max(nb)
        block_imb = makespan * len(nb) / sum(nb)
        nnz_imb = max(nnz) * len(nnz) / sum(nnz) if sum(nnz) else float("inf")
        _metrics.histogram("sharded.block_imbalance", mode=m).observe(block_imb)
        _metrics.histogram("sharded.nnz_imbalance", mode=m).observe(nnz_imb)
        modes[m] = {
            "shard_nblocks": tuple(nb),
            "shard_nnz": tuple(nnz),
            "makespan_blocks": makespan,
            "block_imbalance": block_imb,
            "nnz_imbalance": nnz_imb,
            "busy_fraction": tuple(b / makespan for b in nb),
        }
    return {
        "nshards": len(next(iter(modes.values()))["shard_nblocks"]),
        "modes": modes,
        "worst_block_imbalance": max(r["block_imbalance"] for r in modes.values()),
    }
