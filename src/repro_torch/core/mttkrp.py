"""spMTTKRP compute patterns on the raw COO stream (paper Sec. 3, Alg. 3
and 4), plain PyTorch.  Counterpart of `repro.core.mttkrp`; the planned
kernel lives in `repro_torch.kernels.mttkrp`.

Both approaches compute, for each non-zero x at (i0..iN-1) and output mode m,

    out[i_m, :] += x * prod_{n != m} F_n[i_n, :]

and differ in traversal order:

  * Approach 1 (output direction, Alg. 3): the stream is sorted by the
    output coordinate (the Tensor Remapper's job), so each output row's
    contributions are one contiguous run, summed by a segmented reduction
    (`torch.segment_reduce` over the runs' lengths): no scatter, no partial
    sums of the size of the stream.
  * Approach 2 (input direction, Alg. 4): the stream in any order, each
    contribution scatter-added into its output row (`index_add_`, float32
    atomics on the card).

`mttkrp_sharded` runs either, or the planned kernel, over the shards of a
`ShardingPlan` and reduces their partial outputs.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["hadamard_rows", "mttkrp", "mttkrp_approach1", "mttkrp_approach2", "mttkrp_sharded"]

#: Slots a segment of approach 1's reduction may hold.  A longer run (a hot
#: output row) is summed in segments of SEGMENT slots, and their sums again,
#: so no float32 chain, and no serial loop of the segment kernel, is longer.
SEGMENT = 256


def hadamard_rows(
    indices: torch.Tensor, values: torch.Tensor, factors: Sequence[torch.Tensor], mode: int
) -> torch.Tensor:
    """Per-non-zero Hadamard products of the gathered factor rows, times the
    value.  (nnz, R)."""
    prod = None
    for n, f in enumerate(factors):
        if n == mode:
            continue
        rows = f.index_select(0, indices[:, n])
        prod = rows if prod is None else prod * rows
    if prod is None:
        raise ValueError("need at least one input mode")
    return prod * values[:, None].to(prod.dtype)


def _runs(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(first slot, length) of each run of equal adjacent rows."""
    n = rows.shape[0]
    new = torch.ones(n, dtype=torch.bool, device=rows.device)
    torch.ne(rows[1:], rows[:-1], out=new[1:])
    first = torch.nonzero(new).squeeze(1)
    return first, torch.diff(first, append=first.new_full((1,), n))


def sorted_segment_sum(contrib: torch.Tensor, rows: torch.Tensor, out_rows: int) -> torch.Tensor:
    """Sum the rows of `contrib` into `out_rows` output rows by a segmented
    reduction over `rows`, which must be sorted (non-decreasing): runs
    longer than SEGMENT slots are first cut into segments of SEGMENT slots
    and summed, level by level, until every run is at most that long.
    Raises ValueError where `rows` is not sorted (the segments would then
    sum the wrong slots).  Returns (out_rows, contrib.shape[1])."""
    rows = rows.to(torch.int64)
    if rows.shape[0] == 0:
        return contrib.new_zeros((out_rows, contrib.shape[1]))
    while True:
        first, lengths = _runs(rows)
        if int(lengths.max()) <= SEGMENT:
            break
        offset = torch.arange(rows.shape[0], device=rows.device)
        offset -= torch.repeat_interleave(first, lengths)  # each slot's place in its run
        seg = torch.nonzero(offset % SEGMENT == 0).squeeze(1)
        del offset
        seg_len = torch.diff(seg, append=seg.new_full((1,), rows.shape[0]))
        contrib = torch.segment_reduce(contrib, "sum", lengths=seg_len)
        rows = rows[seg]
    run_rows = rows[first]
    if not bool((run_rows[1:] > run_rows[:-1]).all()):
        raise ValueError("the stream is not sorted by the output mode; pass sorted_by_mode=False "
                         "(or sort it first: `remap_stable`)")
    if int(run_rows[-1]) >= out_rows or int(run_rows[0]) < 0:
        raise ValueError(f"output coordinates out of range [0, {out_rows})")
    # Each output row's run is now one segment (of 0 slots where no slot lands).
    return torch.segment_reduce(contrib, "sum", lengths=torch.bincount(rows, minlength=out_rows))


def mttkrp_approach1(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    out_rows: int,
    sorted_by_mode: bool = True,
) -> torch.Tensor:
    """Approach 1: output-direction MTTKRP over a stream sorted by the
    output mode (Alg. 3), summed by `sorted_segment_sum`.  With
    sorted_by_mode=False the stream may be in any order and the sum takes
    the general path, a scatter-add (the reference's unsorted
    `segment_sum`).  A stream that is not sorted while sorted_by_mode=True
    raises rather than giving wrong sums."""
    contrib = hadamard_rows(indices, values, factors, mode)
    if not sorted_by_mode:
        return _scatter_sum(contrib, indices[:, mode], out_rows)
    return sorted_segment_sum(contrib, indices[:, mode], out_rows)


def _scatter_sum(contrib: torch.Tensor, rows: torch.Tensor, out_rows: int) -> torch.Tensor:
    out = torch.zeros((out_rows, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, rows, contrib)


def mttkrp_approach2(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    out_rows: int,
) -> torch.Tensor:
    """Approach 2: input-direction MTTKRP (Alg. 4) over a stream in any
    order, each contribution scatter-added into its output row."""
    return _scatter_sum(hadamard_rows(indices, values, factors, mode), indices[:, mode], out_rows)


def mttkrp(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    out_rows: int,
    *,
    method: str = "approach1",
    sorted_by_mode: bool = True,
) -> torch.Tensor:
    """Dispatcher: `method` is 'approach1' or 'approach2'.  The planned
    kernel is dispatched in kernels/ops.py (it needs the BlockPlan)."""
    if method == "approach1":
        return mttkrp_approach1(indices, values, factors, mode, out_rows,
                                sorted_by_mode=sorted_by_mode)
    if method == "approach2":
        return mttkrp_approach2(indices, values, factors, mode, out_rows)
    raise ValueError(f"unknown method {method!r}")


def mttkrp_sharded(
    plan,
    mode: int,
    out_rows: int,
    method: str = "approach1",
    *,
    sorted_by_mode: bool = False,
    st=None,
    rank: int | None = None,
    cfg=None,
):
    """An MTTKRP over the shards of `plan` (a `ShardingPlan`), as a callable
    (indices, values, factors) -> (out_rows, R) on the first shard's
    device.

    'approach1' / 'approach2': the stream is cut into `plan.dp_size()`
    contiguous pieces, piece d runs the compute pattern on shard d's
    device with the factors copied there, and the partial outputs are
    reduced (`dist.collective.reduce_partials`).  Pass sorted_by_mode=True
    only when every piece is sorted by the output mode (a stream sorted
    before the cut is).

    'pallas': the planned route (`make_sharded_planned_mttkrp`): the
    host-side `st` and `rank` are required, the stream is partitioned into
    balanced output-tile ranges with one plan per shard; the callable
    ignores its stream arguments, since each shard's layout already lives
    on its device."""
    from ..dist.collective import reduce_partials

    if method == "pallas":
        if st is None or rank is None:
            raise ValueError("mttkrp_sharded(method='pallas') needs the host-side stream: pass "
                             "st=<SparseTensor> and rank=<int> (the partitioner runs on host numpy)")
        from ..kernels.ops import make_sharded_planned_mttkrp  # kernels build on core

        op = make_sharded_planned_mttkrp(st, mode, rank, dist=plan, cfg=cfg)

        def call_planned(indices, values, factors):
            del indices, values  # the shards' layouts live on their devices
            return op.output(factors, out_rows)

        return call_planned
    if method not in ("approach1", "approach2"):
        raise ValueError(f"unknown method {method!r}")
    devices = plan.devices

    def call(indices, values, factors):
        parts = []
        for dev, idx, val in zip(devices, torch.tensor_split(indices, len(devices)),
                                 torch.tensor_split(values, len(devices))):
            parts.append(mttkrp(idx.to(dev), val.to(dev), [f.to(dev) for f in factors], mode,
                                out_rows, method=method, sorted_by_mode=sorted_by_mode))
        return reduce_partials(parts)

    return call
