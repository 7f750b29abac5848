"""The COO stream partitioner and the placement of its shards.

Counterpart of the stream half of `repro.dist.sharding`
(`StreamPartition`, `stream_imbalance`, `partition_stream`), host numpy
with the reference's cut points and shards to the bit, and of its
`ShardingPlan`, which here holds only what the sharded planned path reads:
one `torch.device` per shard.  The LM stack's spec rules (parameter,
activation and batch specs) come with the LM stack.

The split follows the paper's traffic model: each DMA engine serves a
contiguous slice of the output coordinate space, so a shard's remapped
layout (its BlockPlan) writes a disjoint set of output tiles and the
reduction of the partial factor rows across shards is a plain sum.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.coo import SparseTensor

__all__ = ["ShardingPlan", "StreamPartition", "partition_stream", "shard_cut_points",
           "stream_imbalance"]


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Where each shard runs: shard d on `devices[d]`.  A device may appear
    more than once: `(cuda:0,) * 4` runs four shards one after another on
    one card, `(cpu,) * 4` four on the CPU (the counterpart of XLA's forced
    host device count).  Built by `repro_torch.dist.planned.shard_plan`."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a ShardingPlan needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    def dp_size(self) -> int:
        """The number of shards (the reference's data-parallel size)."""
        return len(self.devices)


@dataclasses.dataclass
class StreamPartition:
    """A COO stream split into per-shard output-mode tile ranges.

    Invariants (the reference's, tested in both packages): every non-zero
    lands in exactly one shard; the cut points are multiples of `tile` in
    the output coordinate, so no output tile is split across two shards;
    within a shard the non-zeros keep their order (`positions` increases),
    and `reassemble()` gives back the exact original stream."""

    mode: int  # the output mode the split keys on
    tile: int  # alignment (the plan's tile_i)
    shape: tuple[int, ...]
    tile_bounds: tuple[int, ...]  # nshards + 1 cut points, in tiles
    shards: list[SparseTensor]  # global shape and coordinates
    positions: list[np.ndarray]  # each shard non-zero's place in the stream

    @property
    def nshards(self) -> int:
        return len(self.shards)

    @property
    def shard_nnz(self) -> tuple[int, ...]:
        return tuple(s.nnz for s in self.shards)

    def row_ranges(self) -> tuple[tuple[int, int], ...]:
        """Each shard's [start, end) output rows (tile-aligned; the last
        clipped to the mode length)."""
        n = self.shape[self.mode]
        return tuple((min(b * self.tile, n), min(e * self.tile, n))
                     for b, e in zip(self.tile_bounds[:-1], self.tile_bounds[1:]))

    def imbalance(self) -> float:
        """max / mean shard nnz: 1.0 is a perfect balance."""
        return stream_imbalance(self.shard_nnz)

    def reassemble(self) -> SparseTensor:
        """The shards scattered back into the original stream, order
        included; raises on a non-zero dropped or duplicated."""
        total = sum(self.shard_nnz)
        idx = np.zeros((total, len(self.shape)), np.int32)
        val = np.zeros((total,), np.float32)
        seen = np.zeros((total,), bool)
        for sh, pos in zip(self.shards, self.positions):
            if np.any(seen[pos]):
                raise ValueError("duplicated non-zeros across shards")
            seen[pos] = True
            idx[pos] = sh.indices
            val[pos] = sh.values
        if not np.all(seen):
            raise ValueError("dropped non-zeros: shards do not cover the stream")
        return SparseTensor(idx, val, self.shape)


def stream_imbalance(shard_nnz) -> float:
    """max / mean of per-shard nnz (1.0 for a perfect balance and for an
    empty stream): the balance that `StreamPartition.imbalance` and
    `ShardedPMSEstimate.imbalance` report."""
    total = sum(shard_nnz)
    if total == 0:
        return 1.0
    return max(shard_nnz) / (total / len(shard_nnz))


def shard_cut_points(st: SparseTensor, mode: int, nshards: int, *,
                     tile: int = 1) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """`partition_stream`'s cut points (nshards + 1, in tiles) and each
    shard's nnz, from the per-tile histogram alone: no shard is copied."""
    if nshards < 1:
        raise ValueError(f"nshards must be >= 1, got {nshards}")
    if not 0 <= mode < st.nmodes:
        raise ValueError(f"mode {mode} out of range for a {st.nmodes}-mode tensor")
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    ntiles = max(1, -(-st.shape[mode] // tile))
    tile_of = st.indices[:, mode].astype(np.int64) // tile
    cum = np.cumsum(np.bincount(tile_of, minlength=ntiles))
    # Cut after the tile where the prefix sum first reaches each quantile;
    # searchsorted on the non-decreasing sum keeps the cuts in order.
    targets = int(st.nnz) * np.arange(1, nshards, dtype=np.float64) / nshards
    cuts = np.minimum(np.searchsorted(cum, targets, side="left") + 1, ntiles)
    bounds = np.concatenate([[0], cuts, [ntiles]]).astype(np.int64)
    cum0 = np.concatenate([[0], cum])
    return tuple(int(b) for b in bounds), tuple(int(n) for n in cum0[bounds[1:]] - cum0[bounds[:-1]])


def partition_stream(st: SparseTensor, mode: int, nshards: int, *, tile: int = 1) -> StreamPartition:
    """Split a COO stream into `nshards` contiguous output-mode tile ranges
    with balanced nnz: a greedy split of the per-tile histogram's prefix
    sum at each d / nshards quantile (`shard_cut_points`).

    Every shard keeps the global shape and coordinates, so its plan emits
    global output tile ids and the shards' partial outputs add up to the
    whole.  Cut points are multiples of `tile` (pass the plan's tile_i).
    Shards are empty where nnz or the tile count is smaller than
    `nshards`."""
    bounds, _ = shard_cut_points(st, mode, nshards, tile=tile)
    tile_of = st.indices[:, mode].astype(np.int64) // tile
    # A tile belongs to the last range starting at or before it (equal cut
    # points make empty ranges, resolved in favour of the later shard); one
    # lookup per tile, then a gather per non-zero.
    ntiles = bounds[-1]
    shard_of = (np.searchsorted(np.asarray(bounds), np.arange(ntiles), side="right") - 1)[tile_of]
    shards, positions = [], []
    for d in range(nshards):
        pos = np.flatnonzero(shard_of == d)
        positions.append(pos)
        shards.append(SparseTensor(st.indices[pos], st.values[pos], st.shape))
    return StreamPartition(mode=mode, tile=tile, shape=st.shape, tile_bounds=bounds,
                           shards=shards, positions=positions)
