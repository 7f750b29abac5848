"""Tensor Remapper (paper Alg. 5): the stream remaps of the compute
patterns, and the two-level tile remap that produces the kernels' memory
layout (`BlockPlan`), all built with torch ops on the device.

Counterpart of `repro.core.remap`:
  * `pointer_table`         - the paper's per-bin address pointers (a
                              counting sort's histogram and offsets);
  * `remap_stable`          - a stable sort of the COO stream by one mode,
                              the remap approach 1 runs before each mode;
  * `remap_pointer_machine` - the pointer table emulated element by element
                              on the host (numpy), to certify the sort;
  * `remap_radix`           - `radix_digits` stable counting-sort passes of
                              at most `pointer_budget` bins each, for
                              pointer tables larger than on-chip memory;
  * `plan_blocks`           - the tile-level BlockPlan layout, and
                              `plan_blocks_reference`, its per-group loop.

A stable sort has exactly one result, whichever library runs it, so each
remap gives the reference's order bit for bit.  The build is the reference's vectorized algorithm step for
step — mixed-radix group key, one stable argsort, cumsum of padded group
sizes, one scatter per stream array, `repeat_interleave` for block
metadata — so it returns the same arrays as `repro.core.remap.plan_blocks`
bit for bit: a stable sort has exactly one result, whichever library runs
it.  Building on the card is what makes full-size plans cheap (the host
numpy build takes tens of seconds per mode at NELL-2 size).
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..device import resolve_device
from .coo import SparseTensor
from .memctrl import CacheEngineConfig

__all__ = [
    "BlockPlan",
    "PlanValidationError",
    "group_key",
    "plan_blocks",
    "plan_blocks_reference",
    "plans_validated",
    "pointer_table",
    "radix_digits",
    "remap_pointer_machine",
    "remap_radix",
    "remap_stable",
    "validate_plan",
]


def pointer_table(coords: torch.Tensor, nbins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's address-pointer table: per-bin base addresses.

    Returns int32 (offsets, counts): offsets[b] is where bin b's first
    element goes (the exclusive prefix sum of the histogram)."""
    counts = torch.bincount(coords.to(torch.int64), minlength=nbins)[:nbins].to(torch.int32)
    offsets = torch.zeros_like(counts)
    offsets[1:] = torch.cumsum(counts, 0, dtype=torch.int32)[:-1]
    return offsets, counts


def remap_stable(indices: torch.Tensor, values: torch.Tensor, mode: int):
    """Stable sort of the COO stream by one mode's coordinates, on the
    stream's device: the order the paper's streaming counting sort gives
    (stability keeps the FIFO order of equal coordinates).
    Returns (indices_sorted, values_sorted, perm)."""
    perm = torch.argsort(indices[:, mode], stable=True)
    return indices[perm], values[perm], perm


def remap_pointer_machine(indices: np.ndarray, values: np.ndarray, mode: int, nbins: int):
    """The Tensor Remapper emulated as the paper states it: stream the
    elements one by one, looking up and bumping the output coordinate's
    address pointer (Alg. 5 lines 3-6).  Host numpy; the tests use it to
    certify that `remap_stable` gives the same layout."""
    coords = indices[:, mode]
    counts = np.bincount(coords, minlength=nbins)
    ptr = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    out_idx = np.empty_like(indices)
    out_val = np.empty_like(values)
    for z in range(indices.shape[0]):  # the element-wise store stream
        c = coords[z]
        p = ptr[c]
        out_idx[p] = indices[z]
        out_val[p] = values[z]
        ptr[c] = p + 1
    return out_idx, out_val


def radix_digits(nbins: int, pointer_budget: int) -> int:
    """Counting-sort passes so that pointer_budget**ndigits >= nbins, in
    integer arithmetic (the float form ceil(log(nbins) / log(budget)) is one
    pass too many at exact powers: log(64) / log(4) = 3.0000000000000004)."""
    if pointer_budget < 2:
        raise ValueError(f"need at least two bins per pass, got pointer_budget={pointer_budget}")
    ndigits, span = 1, pointer_budget
    while span < nbins:
        span *= pointer_budget
        ndigits += 1
    return ndigits


def remap_radix(indices: torch.Tensor, values: torch.Tensor, mode: int, nbins: int,
                pointer_budget: int):
    """The remap for pointer tables larger than on-chip memory (paper Sec.
    3.1: a 10 M-coordinate mode needs 40 MB of pointers): radix_digits(nbins,
    budget) stable counting-sort passes, least significant digit first, with
    at most `pointer_budget` pointers live per pass.  Gives `remap_stable`'s
    order.  Returns (indices_sorted, values_sorted, order)."""
    ndigits = radix_digits(max(nbins, 2), pointer_budget)
    key = indices[:, mode]
    order = torch.arange(key.shape[0], device=key.device)
    for _ in range(ndigits):
        p = torch.argsort(key % pointer_budget, stable=True)  # one pass of <= budget bins
        order = order[p]
        key = key[p] // pointer_budget
    return indices[order], values[order], order


@dataclasses.dataclass
class BlockPlan:
    """Kernel memory layout: the remapped non-zero stream plus per-block tile
    metadata, as torch tensors on one device.

    Layout contract (consumed by kernels/mttkrp.py):
      * non-zeros are grouped into blocks of `blk` slots;
      * blocks are sorted by (output tile, then input tile id tuple), so each
        output tile's blocks are contiguous;
      * within a block every element's coordinates fall inside the block's
        tiles; local indices are precomputed;
      * padding slots have value 0 and local index 0.
    """

    vals: torch.Tensor  # (nblocks*blk,) f32
    iloc: torch.Tensor  # (nblocks*blk,) int32 — output-row index within tile
    in_locs: tuple[torch.Tensor, ...]  # N-1 x (nblocks*blk,) int32
    block_it: torch.Tensor  # (nblocks,) int32
    block_in: tuple[torch.Tensor, ...]  # N-1 x (nblocks,) int32
    tile_i: int
    in_tiles: tuple[int, ...]
    blk: int
    out_rows: int  # padded I_out (multiple of tile_i)
    in_rows: tuple[int, ...]  # padded input-mode row counts
    mode: int
    in_modes: tuple[int, ...]
    nnz: int  # true nnz before padding

    @property
    def nblocks(self) -> int:
        return self.block_it.shape[0]

    @property
    def n_in(self) -> int:
        return len(self.in_modes)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def tile_fills(self) -> dict[str, int]:
        """Tile fetches as the reference counts them: a tile is fetched
        again only where the block's tile id changes from the block before.
        Keys: "A" for the output tile, then "B", "C", ... per input mode.
        The same dict as `repro.core.remap.BlockPlan.tile_fills`."""

        def fills(ids: torch.Tensor) -> int:
            if ids.numel() == 0:
                return 0
            return int(1 + torch.count_nonzero(ids[1:] != ids[:-1]).item())

        out = {"A": fills(self.block_it)}
        for n, ids in enumerate(self.block_in):
            out[chr(ord("B") + n)] = fills(ids)
        return out

    def padding_fraction(self) -> float:
        slots = self.vals.shape[0]
        return 1.0 - self.nnz / float(slots) if slots else 0.0

    def output_tile_runs(self) -> int:
        """Contiguous runs of equal output tile ids in the block order."""
        it = self.block_it
        if it.numel() == 0:
            return 0
        return int(1 + torch.count_nonzero(it[1:] != it[:-1]).item())

    def a_tile_single_flush(self) -> bool:
        """Approach-1 invariant: each output tile's blocks are contiguous,
        i.e. there are as many runs as distinct output tiles."""
        return self.output_tile_runs() == torch.unique(self.block_it).numel()


class PlanValidationError(ValueError):
    """A BlockPlan violates its layout contract (see `validate_plan`)."""


def plans_validated() -> bool:
    """True when `REPRO_VALIDATE_PLANS` asks for every plan to be validated
    at build time (the reference's opt-in switch)."""
    return os.environ.get("REPRO_VALIDATE_PLANS", "").strip().lower() in (
        "1", "true", "yes", "on",
    )


def validate_plan(plan: BlockPlan) -> BlockPlan:
    """Check every BlockPlan invariant of the layout contract and raise
    `PlanValidationError` naming the first violation; returns the plan.
    The same checks as `repro.core.remap.validate_plan`."""

    def fail(msg: str):
        raise PlanValidationError(f"BlockPlan(mode={plan.mode}, nnz={plan.nnz}): {msg}")

    def bounds(t: torch.Tensor) -> tuple[int, int]:
        return int(t.min().item()), int(t.max().item())

    n_in = plan.n_in
    if not (len(plan.in_locs) == len(plan.block_in) == len(plan.in_tiles)
            == len(plan.in_rows) == n_in):
        fail("inconsistent input-mode arity across "
             "in_locs/block_in/in_tiles/in_rows/in_modes")
    if plan.mode in plan.in_modes or len(set(plan.in_modes)) != n_in:
        fail(f"in_modes {plan.in_modes} must be distinct and exclude the "
             f"output mode {plan.mode}")
    if plan.blk < 1:
        fail(f"blk={plan.blk} must be >= 1")
    total = plan.nblocks * plan.blk
    for name, arr in (("vals", plan.vals), ("iloc", plan.iloc),
                      *((f"in_locs[{n}]", plan.in_locs[n]) for n in range(n_in))):
        if tuple(arr.shape) != (total,):
            fail(f"{name} has shape {tuple(arr.shape)}, expected ({total},) = nblocks*blk")
    for n in range(n_in):
        if tuple(plan.block_in[n].shape) != (plan.nblocks,):
            fail(f"block_in[{n}] has shape {tuple(plan.block_in[n].shape)}, "
                 f"expected ({plan.nblocks},)")
    if plan.out_rows % plan.tile_i != 0:
        fail(f"out_rows={plan.out_rows} not a multiple of tile_i={plan.tile_i}")
    for n in range(n_in):
        if plan.in_rows[n] % plan.in_tiles[n] != 0:
            fail(f"in_rows[{n}]={plan.in_rows[n]} not a multiple of "
                 f"in_tiles[{n}]={plan.in_tiles[n]}")
    if not bool(torch.isfinite(plan.vals).all()):
        fail("non-finite values in the remapped stream")
    if total < plan.nnz:
        fail(f"stream holds {total} slots but the plan claims nnz={plan.nnz}")
    nz = int(torch.count_nonzero(plan.vals).item())
    if nz > plan.nnz:
        fail(f"{nz} non-zero slots exceed nnz={plan.nnz} — padding slots "
             f"must be zero-valued")
    if plan.iloc.numel():
        lo, hi = bounds(plan.iloc)
        if lo < 0 or hi >= plan.tile_i:
            fail(f"iloc out of tile bounds [0, {plan.tile_i}): range [{lo}, {hi}]")
    for n in range(n_in):
        if plan.in_locs[n].numel():
            lo, hi = bounds(plan.in_locs[n])
            if lo < 0 or hi >= plan.in_tiles[n]:
                fail(f"in_locs[{n}] out of tile bounds [0, {plan.in_tiles[n]}): "
                     f"range [{lo}, {hi}]")
    ntiles = plan.out_rows // plan.tile_i
    if plan.block_it.numel():
        lo, hi = bounds(plan.block_it)
        if lo < 0 or hi >= ntiles:
            fail(f"block_it out of range [0, {ntiles}): range [{lo}, {hi}]")
    for n in range(n_in):
        nt = plan.in_rows[n] // plan.in_tiles[n]
        if plan.block_in[n].numel():
            lo, hi = bounds(plan.block_in[n])
            if lo < 0 or hi >= nt:
                fail(f"block_in[{n}] out of range [0, {nt}): range [{lo}, {hi}]")
    if not plan.a_tile_single_flush():
        fail("Approach-1 contiguity violated: an output tile's blocks are "
             "not contiguous")
    return plan


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _ceil_div(x: int, m: int) -> int:
    return max(1, (x + m - 1) // m)


def group_key(tile_cols: list[torch.Tensor], tile_counts: list[int]) -> torch.Tensor:
    """Mixed-radix encoding of per-mode tile ids into one collision-free
    int64 key; every id in `tile_cols[m]` must be < tile_counts[m]."""
    if len(tile_cols) != len(tile_counts):
        raise ValueError("one tile count per tile-id column")
    radix = math.prod(int(c) for c in tile_counts)
    if radix > torch.iinfo(torch.int64).max:
        raise OverflowError(
            f"group_key radix {radix} overflows int64: tile counts "
            f"{tuple(tile_counts)} — use larger tiles for the big modes"
        )
    key = torch.zeros_like(tile_cols[0], dtype=torch.int64)
    for col, count in zip(tile_cols, tile_counts):
        if count < 1:
            raise ValueError(f"tile count {count} must be >= 1")
        key = key * int(count) + col.to(torch.int64)
    return key


@dataclasses.dataclass
class _GroupedStream:
    """Shared prologue of both builders: the remap permutation plus the group
    geometry, with the stream arrays kept in original order."""

    order: torch.Tensor  # stable sort permutation of the group key
    i: torch.Tensor  # output-mode coordinates, original order (int64)
    ins: list[torch.Tensor]  # input-mode coordinates, original order (int64)
    v: torch.Tensor  # values, original order
    it: torch.Tensor  # output tile ids, original order
    in_ts: list[torch.Tensor]  # input tile ids, original order
    boundaries: torch.Tensor  # first sorted position of each group
    group_sizes: torch.Tensor
    padded_sizes: torch.Tensor  # group sizes rounded up to a multiple of blk
    in_modes: tuple[int, ...]
    in_tiles: tuple[int, ...]

    @property
    def total(self) -> int:
        return int(self.padded_sizes.sum().item())


def _grouped_stream(
    st: SparseTensor,
    mode: int,
    tile_i: int,
    tile_j: int,
    tile_k: int,
    blk: int,
    in_tiles: tuple[int, ...] | None,
    device: torch.device,
) -> _GroupedStream:
    if st.nmodes < 3:
        raise ValueError("the kernel block plan needs a tensor of >= 3 modes")
    in_modes = tuple(m for m in range(st.nmodes) if m != mode)
    n_in = len(in_modes)
    if in_tiles is None:
        in_tiles = CacheEngineConfig(tile_j=tile_j, tile_k=tile_k).input_tiles(n_in)
    if len(in_tiles) != n_in:
        raise ValueError(f"{len(in_tiles)} input tiles for {n_in} input modes")
    i = torch.from_numpy(st.indices[:, mode]).to(device, torch.int64)
    ins = [torch.from_numpy(st.indices[:, m]).to(device, torch.int64) for m in in_modes]
    v = torch.from_numpy(st.values).to(device)

    it = i // tile_i
    in_ts = [c // t for c, t in zip(ins, in_tiles)]
    # Remap: one stable argsort on the mixed-radix key of (output tile,
    # input tile tuple) — the same permutation as the reference's.
    n_tiles = [_ceil_div(st.shape[mode], tile_i)] + [
        _ceil_div(st.shape[m], t) for m, t in zip(in_modes, in_tiles)
    ]
    key = group_key([it] + in_ts, n_tiles)
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    del key

    starts = torch.ones(key_sorted.shape, dtype=torch.bool, device=device)
    starts[1:] = key_sorted[1:] != key_sorted[:-1]
    boundaries = torch.nonzero(starts).flatten()
    del starts, key_sorted
    ends = torch.cat([boundaries[1:], torch.tensor([st.nnz], device=device)])
    group_sizes = ends - boundaries
    padded_sizes = torch.clamp(((group_sizes + blk - 1) // blk) * blk, min=_ceil_to(1, blk))
    return _GroupedStream(
        order=order,
        i=i,
        ins=ins,
        v=v,
        it=it,
        in_ts=in_ts,
        boundaries=boundaries,
        group_sizes=group_sizes,
        padded_sizes=padded_sizes,
        in_modes=in_modes,
        in_tiles=tuple(int(t) for t in in_tiles),
    )


def _assemble_plan(st, mode, g: _GroupedStream, tile_i, blk, vals, iloc,
                   in_locs, block_it, block_in) -> BlockPlan:
    plan = BlockPlan(
        vals=vals,
        iloc=iloc,
        in_locs=tuple(in_locs),
        block_it=block_it,
        block_in=tuple(block_in),
        tile_i=tile_i,
        in_tiles=g.in_tiles,
        blk=blk,
        out_rows=_ceil_to(st.shape[mode], tile_i),
        in_rows=tuple(_ceil_to(st.shape[m], t) for m, t in zip(g.in_modes, g.in_tiles)),
        mode=mode,
        in_modes=g.in_modes,
        nnz=st.nnz,
    )
    if plans_validated():
        validate_plan(plan)
    return plan


def plan_blocks(
    st: SparseTensor,
    mode: int,
    *,
    tile_i: int = 256,
    tile_j: int = 256,
    tile_k: int = 256,
    blk: int = 256,
    in_tiles: tuple[int, ...] | None = None,
    device: str | torch.device | None = None,
) -> BlockPlan:
    """Two-level tile remap of `st` for output mode `mode`, built on
    `device` (CUDA unless the caller passes one).

    One scatter moves every non-zero to its padded destination (cumsum of
    padded group sizes -> per-group destination offsets) and
    `repeat_interleave` expands per-group tile ids to per-block metadata.
    Bit-identical to `plan_blocks_reference` and to the reference package's
    `plan_blocks`."""
    device = resolve_device(device)
    g = _grouped_stream(st, mode, tile_i, tile_j, tile_k, blk, in_tiles, device)
    n_in = len(g.in_modes)
    total = g.total
    nnz = g.i.shape[0]
    order = g.order

    # Destination of each sorted non-zero: its group's padded base offset
    # plus its rank within the group.
    dst_off = torch.cumsum(g.padded_sizes, 0) - g.padded_sizes
    flags = torch.zeros((nnz,), dtype=torch.int64, device=device)
    flags[g.boundaries[1:]] = 1
    gid = torch.cumsum(flags, 0)
    del flags
    dest = dst_off[gid] + (torch.arange(nnz, dtype=torch.int64, device=device) - g.boundaries[gid])
    del gid

    vals = torch.zeros((total,), dtype=torch.float32, device=device)
    iloc = torch.zeros((total,), dtype=torch.int32, device=device)
    in_locs = [torch.zeros((total,), dtype=torch.int32, device=device) for _ in range(n_in)]
    vals[dest] = g.v[order]
    iloc[dest] = (g.i - g.it * tile_i).to(torch.int32)[order]
    for n in range(n_in):
        in_locs[n][dest] = (g.ins[n] - g.in_ts[n] * g.in_tiles[n]).to(torch.int32)[order]
    del dest

    # Per-block tile ids: each group contributes padded_size/blk identical
    # blocks; `leaders` are the original positions of each group's first
    # sorted element.
    nb_per_group = g.padded_sizes // blk
    nblocks = total // blk
    leaders = order[g.boundaries]
    block_it = torch.repeat_interleave(
        g.it[leaders], nb_per_group, output_size=nblocks).to(torch.int32)
    block_in = [
        torch.repeat_interleave(t[leaders], nb_per_group, output_size=nblocks).to(torch.int32)
        for t in g.in_ts
    ]
    return _assemble_plan(st, mode, g, tile_i, blk, vals, iloc, in_locs, block_it, block_in)


def plan_blocks_reference(
    st: SparseTensor,
    mode: int,
    *,
    tile_i: int = 256,
    tile_j: int = 256,
    tile_k: int = 256,
    blk: int = 256,
    in_tiles: tuple[int, ...] | None = None,
    device: str | torch.device | None = None,
) -> BlockPlan:
    """Per-group Python-loop layout build: the executable specification
    `plan_blocks` must match bit for bit.  Small tensors only."""
    device = resolve_device(device)
    g = _grouped_stream(st, mode, tile_i, tile_j, tile_k, blk, in_tiles, device)
    n_in = len(g.in_modes)
    total = g.total
    nblocks = total // blk

    order = g.order
    i, v, it = g.i[order], g.v[order], g.it[order]
    ins = [c[order] for c in g.ins]
    in_ts = [t[order] for t in g.in_ts]

    vals = torch.zeros((total,), dtype=torch.float32, device=device)
    iloc = torch.zeros((total,), dtype=torch.int32, device=device)
    in_locs = [torch.zeros((total,), dtype=torch.int32, device=device) for _ in range(n_in)]
    block_it = torch.empty((nblocks,), dtype=torch.int32, device=device)
    block_in = [torch.empty((nblocks,), dtype=torch.int32, device=device) for _ in range(n_in)]

    src = dst = b = 0
    for gsize, psize in zip(g.group_sizes.tolist(), g.padded_sizes.tolist()):
        s, e = src, src + gsize
        vals[dst: dst + gsize] = v[s:e]
        iloc[dst: dst + gsize] = (i[s:e] - it[s] * tile_i).to(torch.int32)
        for n in range(n_in):
            in_locs[n][dst: dst + gsize] = (ins[n][s:e] - in_ts[n][s] * g.in_tiles[n]).to(torch.int32)
        nb = psize // blk
        block_it[b: b + nb] = it[s]
        for n in range(n_in):
            block_in[n][b: b + nb] = in_ts[n][s]
        src = e
        dst += psize
        b += nb
    return _assemble_plan(st, mode, g, tile_i, blk, vals, iloc, in_locs, block_it, block_in)
