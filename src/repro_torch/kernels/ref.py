"""Plain PyTorch oracles for the MTTKRP, TTMc and TT-core kernels.
Counterpart of `repro.kernels.ref`:

  * `mttkrp_ref`      — gather -> Hadamard -> index_add_ over the raw stream;
  * `mttkrp_ref_dense` — densify-and-einsum cross-check (3 modes, float64,
                        tiny shapes);
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

`ttmc_ref` and `ttcore_ref` take the raw stream in steps of as many
non-zeros as keep a step's widest rows to REF_ELEMS elements: at NELL-2
size a 256-column right-hand side of all 76.9 M non-zeros at once would be
79 GB.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..core.mttkrp import mttkrp_approach2
from .tt import chain_left, chain_right
from .ttm import kron_rows

__all__ = ["mttkrp_ref", "mttkrp_ref_dense", "mttkrp_plan_ref", "ttmc_ref", "ttmc_ref_dense", "ttmc_plan_ref",
           "ttcore_ref", "ttcore_ref_dense", "ttcore_plan_ref"]

#: Non-zero-by-column elements per step of the raw-stream references.
REF_ELEMS = 1 << 26


def mttkrp_ref(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    out_rows: int,
) -> torch.Tensor:
    """MTTKRP over the raw stream in any order (a scatter-add)."""
    return mttkrp_approach2(indices, values, factors, mode, out_rows)


def mttkrp_ref_dense(
    indices: np.ndarray,
    values: np.ndarray,
    factors: Sequence[np.ndarray],
    mode: int,
    out_rows: int,
) -> np.ndarray:
    """Densify-and-einsum cross-check for 3 modes (repeated coordinates add
    up; float64 inside).  numpy in and out, float32 out."""
    if len(factors) != 3:
        raise ValueError(f"the dense cross-check takes 3 modes, got {len(factors)}")
    shape = tuple(int(f.shape[0]) for f in factors)
    dense = np.zeros(shape, np.float64)
    np.add.at(dense, tuple(indices[:, m] for m in range(3)), values.astype(np.float64))
    ins = [n for n in range(3) if n != mode]
    letters = "ijk"
    spec = f"ijk,{letters[ins[0]]}r,{letters[ins[1]]}r->{letters[mode]}r"
    out = np.einsum(spec, dense, factors[ins[0]].astype(np.float64), factors[ins[1]].astype(np.float64))
    return out[:out_rows].astype(np.float32)


def _step(width: int) -> int:
    """Non-zeros per step of a raw-stream reference whose widest per-non-zero
    rows hold `width` elements."""
    return max(1, REF_ELEMS // max(width, 1))


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
    factor matrices; the mode-th is ignored.  Taken in steps of non-zeros
    (see the module note).  (out_rows, prod of input ranks)."""
    ncols = math.prod(int(f.shape[1]) for n, f in enumerate(factors) if n != mode)
    step = _step(ncols)
    out = torch.zeros((out_rows, ncols), dtype=factors[0].dtype, device=values.device)
    for z0 in range(0, values.shape[0], step):
        idx = indices[z0: z0 + step]
        contrib = values[z0: z0 + step, None].to(factors[0].dtype)
        for n, f in enumerate(factors):
            if n != mode:
                contrib = kron_rows(contrib, f.index_select(0, idx[:, n]))
        out.index_add_(0, idx[:, mode], contrib)
    return out


def ttmc_ref_dense(
    indices: np.ndarray,
    values: np.ndarray,
    factors: Sequence[np.ndarray],
    mode: int,
    out_rows: int,
) -> np.ndarray:
    """Densify-and-einsum cross-check of the TTM chain for 3-5 modes
    (repeated coordinates add up; float64 inside): every mode but `mode`
    contracted with its factor, the rank axes flattened row-major.  numpy
    in and out, float32 out."""
    nmodes = len(factors)
    if not 3 <= nmodes <= 5:
        raise ValueError(f"the dense cross-check takes 3-5 modes, got {nmodes}")
    shape = tuple(int(f.shape[0]) for f in factors)
    dense = np.zeros(shape, np.float64)
    np.add.at(dense, tuple(indices[:, m] for m in range(nmodes)), values.astype(np.float64))
    ins = [n for n in range(nmodes) if n != mode]
    letters, ranks = "abcde"[:nmodes], "vwxyz"
    spec = (letters + "," + ",".join(letters[n] + ranks[k] for k, n in enumerate(ins))
            + "->" + letters[mode] + ranks[:len(ins)])
    out = np.einsum(spec, dense, *[factors[n].astype(np.float64) for n in ins])
    return out.reshape(shape[mode], -1)[:out_rows].astype(np.float32)


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
    (rl_k, I_k, rr_k); the mode-th is ignored.  Taken in steps of non-zeros
    (see the module note).  (out_rows, rl_m * rr_m)."""
    rl, rr = int(cores[mode].shape[0]), int(cores[mode].shape[2])
    # The widest per-non-zero temporary: an interface chain's (rl_k, rr_k)
    # rows, or the output's rl * rr columns.
    widest = max([rl * rr] + [int(c.shape[0]) * int(c.shape[2]) for c in cores])
    step = _step(widest)
    mats = [c.permute(1, 0, 2) for c in cores]
    out = torch.zeros((out_rows, rl * rr), dtype=values.dtype, device=values.device)
    for z0 in range(0, values.shape[0], step):
        idx = indices[z0: z0 + step]
        rows3 = [w.index_select(0, idx[:, k]).to(values.dtype)
                 for k, w in enumerate(mats) if k != mode]
        out.index_add_(0, idx[:, mode].to(torch.int64),
                       _tt_contrib(values[z0: z0 + step], rows3, mode))
    return out


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
