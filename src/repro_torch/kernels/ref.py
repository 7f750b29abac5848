"""Plain PyTorch oracles for the MTTKRP, TTMc and TT-core kernels.
Counterpart of `repro.kernels.ref`:

  * `mttkrp_ref`      — gather -> Hadamard -> index_add_ over the raw stream;
  * `mttkrp_plan_ref` — the same on the kernel's BlockPlan layout, padded
                        rows included;
  * `ttmc_ref`        — gather -> Kronecker chain -> index_add_ over the raw
                        stream (columns row-major over ascending input mode);
  * `ttmc_plan_ref`   — the same on the BlockPlan layout;
  * `ttcore_ref`      — the TT-ALS right-hand side over the raw stream: the
                        left and right interface chains of the other cores,
                        their Kronecker product (rl slow, rr fast) ->
                        index_add_;
  * `ttcore_ref_dense` — the same by densifying (float64, tiny shapes);
  * `ttcore_plan_ref` — the same on the BlockPlan layout.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.mttkrp import mttkrp_approach1
from .tt import chain_left, chain_right
from .ttm import kron_rows

__all__ = ["mttkrp_ref", "mttkrp_plan_ref", "ttmc_ref", "ttmc_plan_ref", "ttcore_ref",
           "ttcore_ref_dense", "ttcore_plan_ref"]


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


def _tt_contrib(values: torch.Tensor, rows3: Sequence[torch.Tensor], n_left: int) -> torch.Tensor:
    """values * kron(left, right) per non-zero, from each input's gathered
    (nnz, rl, rr) rows: the first n_left chain from the left, ascending, the
    others from the right, descending."""
    nnz = values.shape[0]
    left = torch.ones((nnz, 1), dtype=values.dtype, device=values.device)
    for rows in rows3[:n_left]:
        left = chain_left(left, rows)
    right = torch.ones((nnz, 1), dtype=values.dtype, device=values.device)
    for rows in reversed(rows3[n_left:]):
        right = chain_right(rows, right)
    return values[:, None] * kron_rows(left, right)


def ttcore_ref(
    indices: torch.Tensor,
    values: torch.Tensor,
    cores: Sequence[torch.Tensor],
    mode: int,
    out_rows: int,
) -> torch.Tensor:
    """Sparse TT-ALS right-hand side: B[i_m, :] += v * kron(l, r), l the left
    interface chain over cores < mode, r the right chain over cores > mode,
    columns row-major over (rl_m, rr_m).  `cores` holds all N TT cores,
    (rl_k, I_k, rr_k); the mode-th is ignored.  (out_rows, rl_m * rr_m)."""
    rows3 = [c.permute(1, 0, 2).index_select(0, indices[:, k]).to(values.dtype)
             for k, c in enumerate(cores) if k != mode]
    contrib = _tt_contrib(values, rows3, mode)
    out = torch.zeros((out_rows, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, indices[:, mode].to(torch.int64), contrib)


def ttcore_ref_dense(
    indices: torch.Tensor,
    values: torch.Tensor,
    cores: Sequence[torch.Tensor],
    mode: int,
    out_rows: int,
) -> torch.Tensor:
    """Densify-and-contract cross-check for 3-5 modes (repeated coordinates
    add up; float64 inside): the dense tensor contracted with the left
    interface (modes < mode folded into an rl_m-wide matrix) and the right
    interface (modes > mode into rr_m), (rl, rr) flattened row-major.
    Returns float32 (out_rows, rl_m * rr_m)."""
    nmodes = len(cores)
    if not 3 <= nmodes <= 5:
        raise ValueError(f"the dense cross-check takes 3-5 modes, got {nmodes}")
    cores = [c.to(torch.float64) for c in cores]
    shape = tuple(int(c.shape[1]) for c in cores)
    dense = torch.zeros(shape, dtype=torch.float64, device=values.device)
    dense.index_put_(tuple(indices[:, m].to(torch.int64) for m in range(nmodes)),
                     values.to(torch.float64), accumulate=True)
    left = torch.ones((1, 1), dtype=torch.float64, device=values.device)
    for c in cores[:mode]:  # (prod(shape[:k+1]), rr_k)
        left = torch.einsum("pa,aib->pib", left, c).reshape(-1, c.shape[2])
    right = torch.ones((1, 1), dtype=torch.float64, device=values.device)
    for c in reversed(cores[mode + 1:]):  # (rl_k, prod(shape[k:]))
        right = torch.einsum("aib,bq->aiq", c, right).reshape(c.shape[0], -1)
    d3 = dense.reshape(left.shape[0], shape[mode], right.shape[1])
    out = torch.einsum("piq,pa,bq->iab", d3, left, right)
    return out.reshape(shape[mode], -1)[:out_rows].to(torch.float32)


def ttcore_plan_ref(plan, factors_padded: Sequence[torch.Tensor],
                    in_rank_pairs: Sequence[tuple[int, int]], n_left: int) -> torch.Tensor:
    """What the TT-core kernel must produce on `plan`, padded rows included,
    true columns only: one lane-padded interface matrix per input mode
    (plan.in_modes order).  Returns (out_rows, rl_m * rr_m)."""
    blk = plan.blk
    rows3 = [f_pad.index_select(0, _global_rows(tids, loc, tile, blk))[:, : a * b].reshape(-1, a, b)
             for f_pad, tids, loc, tile, (a, b) in zip(factors_padded, plan.block_in, plan.in_locs,
                                                       plan.in_tiles, in_rank_pairs)]
    contrib = _tt_contrib(plan.vals, rows3, n_left)
    gi = _global_rows(plan.block_it, plan.iloc, plan.tile_i, blk)
    out = torch.zeros((plan.out_rows, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, gi, contrib)
