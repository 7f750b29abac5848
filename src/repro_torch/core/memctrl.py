"""Memory-controller configuration, as plan geometry only.

Counterpart of `repro.core.memctrl`.  The port uses these dataclasses for
the BlockPlan geometry (`tile_i`, the input tiles, `blk`); the reference's
TPU hardware constants and VMEM footprint model, with the fields only that
model reads (`resident_tiles`, `buffers`), are not carried over — a Hopper
memory model (shared memory per CTA, L2) is later work.  `RemapperConfig`
keeps its fields for that model and for the radix remap.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "CacheEngineConfig",
    "DMAEngineConfig",
    "RemapperConfig",
    "MemoryControllerConfig",
]


@dataclasses.dataclass(frozen=True)
class CacheEngineConfig:
    tile_i: int = 256  # output-tile rows
    tile_j: int = 256  # first input mode's tile rows
    tile_k: int = 256  # every further input mode's tile rows

    def input_tiles(self, n_in: int = 2) -> tuple[int, ...]:
        """Per-input-mode tile sizes for an N-mode tensor: the first input
        mode uses tile_j, every further one tile_k."""
        if n_in < 1:
            raise ValueError(f"n_in must be >= 1, got {n_in}")
        return ((self.tile_j,) + (self.tile_k,) * (n_in - 1))[:n_in]


@dataclasses.dataclass(frozen=True)
class DMAEngineConfig:
    blk: int = 256  # non-zero slots per plan block


@dataclasses.dataclass(frozen=True)
class RemapperConfig:
    pointer_budget: int = 1 << 20
    index_bytes: int = 4
    value_bytes: int = 4


@dataclasses.dataclass(frozen=True)
class MemoryControllerConfig:
    cache: CacheEngineConfig = CacheEngineConfig()
    dma: DMAEngineConfig = DMAEngineConfig()
    remapper: RemapperConfig = RemapperConfig()
