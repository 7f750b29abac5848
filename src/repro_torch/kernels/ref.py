"""Plain PyTorch oracles for the MTTKRP and TTMc kernels.  Counterpart of
the MTTKRP and TTMc parts of `repro.kernels.ref`:

  * `mttkrp_ref`      — gather -> Hadamard -> index_add_ over the raw stream;
  * `mttkrp_plan_ref` — the same on the kernel's BlockPlan layout, padded
                        rows included;
  * `ttmc_ref`        — gather -> Kronecker chain -> index_add_ over the raw
                        stream (columns row-major over ascending input mode);
  * `ttmc_plan_ref`   — the same on the BlockPlan layout.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.mttkrp import mttkrp_approach1
from .ttm import kron_rows

__all__ = ["mttkrp_ref", "mttkrp_plan_ref", "ttmc_ref", "ttmc_plan_ref"]


def mttkrp_ref(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    out_rows: int,
) -> torch.Tensor:
    return mttkrp_approach1(indices, values, factors, mode, out_rows)


def _global_rows(tile_ids: torch.Tensor, locs: torch.Tensor, tile: int, blk: int) -> torch.Tensor:
    return torch.repeat_interleave(tile_ids.to(torch.int64), blk) * tile + locs.to(torch.int64)


def mttkrp_plan_ref(plan, factors_padded: Sequence[torch.Tensor]) -> torch.Tensor:
    """What the kernel must produce on `plan`: one padded factor per input
    mode (plan.in_modes order).  Returns (out_rows, factor width)."""
    blk = plan.blk
    contrib = plan.vals[:, None]
    for f_pad, tids, loc, tile in zip(factors_padded, plan.block_in, plan.in_locs, plan.in_tiles):
        contrib = contrib * f_pad.index_select(0, _global_rows(tids, loc, tile, blk))
    gi = _global_rows(plan.block_it, plan.iloc, plan.tile_i, blk)
    out = torch.zeros((plan.out_rows, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, gi, contrib)


def ttmc_ref(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    out_rows: int,
) -> torch.Tensor:
    """Sparse TTM chain: Y[i_n, :] += v * kron(rows of every factor != mode),
    columns row-major over ascending input mode.  `factors` holds all N
    factor matrices; the mode-th is ignored.  (out_rows, prod of input ranks)."""
    contrib = values[:, None].to(factors[0].dtype)
    for n, f in enumerate(factors):
        if n != mode:
            contrib = kron_rows(contrib, f.index_select(0, indices[:, n]))
    out = torch.zeros((out_rows, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, indices[:, mode], contrib)


def ttmc_plan_ref(plan, factors_padded: Sequence[torch.Tensor], in_ranks: Sequence[int]) -> torch.Tensor:
    """What the TTMc kernel must produce on `plan`, padded rows included, true
    columns only: one lane-padded factor per input mode (plan.in_modes
    order).  Returns (out_rows, prod(in_ranks))."""
    blk = plan.blk
    contrib = plan.vals[:, None]
    for f_pad, tids, loc, tile, r in zip(factors_padded, plan.block_in, plan.in_locs,
                                         plan.in_tiles, in_ranks):
        contrib = kron_rows(contrib, f_pad.index_select(0, _global_rows(tids, loc, tile, blk))[:, :r])
    gi = _global_rows(plan.block_it, plan.iloc, plan.tile_i, blk)
    out = torch.zeros((plan.out_rows, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, gi, contrib)
