"""Blocked sorted-COO TTM chain (TTMc) on a BlockPlan: the wrapper of the
Hopper kernel (`csrc/ttmc.cu`) and its plain PyTorch version.

Counterpart of `repro.kernels.ttm_pallas` (`ttmc_pallas_call`, `kron_cols`,
`cols_padded`).  For output mode n it computes the unfolding

    Y[i_n, :] += v * kron(U_m[i_m, :r_m] for m in plan.in_modes)

over the plan's slots, with the columns in row-major order over the input
modes (the last input mode varies fastest).  Each input factor keeps its own
rank r_m and its own padded width; only its true r_m lanes are read.

`ttmc_blocked` launches the CUDA kernel for CUDA tensors and runs
`ttmc_blocked_plain` only for tensors on the CPU; `ttmc_blocked.launches`
counts kernel launches.  As for MTTKRP, the wrapper allocates the output
zeroed: rows no non-zero reaches and padded lanes are exactly 0, and plans
of more than 4 input modes take the kernel's wide path.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..core.remap import BlockPlan
from .mttkrp import (
    LAUNCH_TAIL,
    MAX_TEMPLATE_IN,
    WIDE_LAUNCH_TAIL,
    _rows,
    check_plan_args,
    launch_fn,
    rank_padded,
    wide_table,
)

__all__ = ["cols_padded", "kron_cols", "kron_rows", "ttmc_blocked", "ttmc_blocked_plain"]

#: Slot-by-column elements per step of the plain version: its Kronecker
#: temporaries grow with the output width, so the step is sized by both.
PLAIN_ELEMS = 1 << 24


def kron_cols(in_ranks: Sequence[int]) -> int:
    """True output columns: P = the product of the input-factor ranks."""
    return math.prod(int(r) for r in in_ranks)


def cols_padded(ncols: int) -> int:
    """Lane padding of the TTMc output: P rounded up like a factor's rank
    (a multiple of 4; the reference pads to 128 TPU lanes)."""
    return rank_padded(ncols)


def kron_rows(contrib: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Row-wise Kronecker product: (n, a) x (n, b) -> (n, a*b), b fastest."""
    return (contrib[:, :, None] * rows[:, None, :]).reshape(contrib.shape[0], -1)


def _check(plan: BlockPlan, factors_pad: Sequence[torch.Tensor], in_ranks: Sequence[int],
           dtype: torch.dtype) -> tuple[int, ...]:
    """Raise on anything the kernel does not take; returns the ranks as ints.
    Factor n must hold at least in_ranks[n] lanes."""
    in_ranks = tuple(int(r) for r in in_ranks)
    if len(in_ranks) != plan.n_in or min(in_ranks, default=0) < 1:
        raise ValueError(f"in_ranks {in_ranks}: expected {plan.n_in} ranks >= 1, "
                         f"one per input mode")
    check_plan_args(plan, factors_pad, dtype, in_ranks)
    return in_ranks


def ttmc_blocked_plain(plan: BlockPlan, factors_pad: Sequence[torch.Tensor],
                       in_ranks: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather each slot's input rows,
    slice them to the true ranks, chain their Kronecker products onto the
    value in plan.in_modes order, `index_add_` into the output rows; in
    block-aligned steps of about `PLAIN_ELEMS` slot-columns (an unchunked
    pass at NELL-2 size would hold 107 M slots x 256 columns).  Padding
    slots are computed like any other (value 0 adds 0).

    Computes in the dtype of its inputs: float32 like the kernel, or float64
    (plan.vals and factors cast up) for a reference whose own rounding is
    negligible.  Returns (plan.out_rows, cols_padded(P))."""
    dtype = torch.float64 if plan.vals.dtype == torch.float64 else torch.float32
    in_ranks = _check(plan, factors_pad, in_ranks, dtype)
    ncols = kron_cols(in_ranks)
    out = torch.zeros((plan.out_rows, cols_padded(ncols)), dtype=dtype, device=plan.device)
    step = max(1, PLAIN_ELEMS // (plan.blk * ncols))
    for b0 in range(0, plan.nblocks, step):
        b1 = min(plan.nblocks, b0 + step)
        s0, s1 = b0 * plan.blk, b1 * plan.blk
        contrib = plan.vals[s0:s1, None]
        for f, tids, locs, tile, r in zip(factors_pad, plan.block_in, plan.in_locs,
                                          plan.in_tiles, in_ranks):
            rows = f.index_select(0, _rows(tids[b0:b1], locs[s0:s1], tile).flatten())[:, :r]
            contrib = kron_rows(contrib, rows)
        rows = _rows(plan.block_it[b0:b1], plan.iloc[s0:s1], plan.tile_i).flatten()
        out[:, :ncols].index_add_(0, rows, contrib)
    return out


_VP, _PTRS, _INTS = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
#: The arguments both TTMc launches take first.
_HEAD = [_VP, _VP, _VP, _PTRS, _PTRS, _PTRS, _INTS, _INTS, _INTS, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP]


def _library() -> ctypes.CDLL:
    from .build import load  # builds on first use, never at import

    return load("ttmc")


def ttmc_blocked(plan: BlockPlan, factors_pad: Sequence[torch.Tensor],
                 in_ranks: Sequence[int]) -> torch.Tensor:
    """TTMc on `plan` with one padded factor per input mode (plan.in_modes
    order; factor n has >= plan.in_rows[n] rows and >= in_ranks[n] columns,
    of which the first in_ranks[n] are read).

    CUDA tensors launch the Hopper kernel on the current stream (one launch,
    counted, whatever the output width); CPU tensors run
    `ttmc_blocked_plain`.  Any tile_i and ranks run: the kernel splits a
    tile into row parts and a row wider than its registers hold into column
    slices; plans of more than MAX_TEMPLATE_IN input modes take the wide
    path.  Raises ValueError where the wide path's digits leave no room for
    a sorted slot in a CTA's shared memory, RuntimeError if the launch
    fails.  Returns
    (plan.out_rows, cols_padded(P)) float32, zero wherever no non-zero lands
    and in every padded lane."""
    dev = plan.vals.device
    if dev.type == "cpu":
        return ttmc_blocked_plain(plan, factors_pad, in_ranks)
    if dev.type != "cuda":
        raise ValueError(f"ttmc_blocked runs on CUDA or CPU tensors, got {dev}")
    in_ranks = _check(plan, factors_pad, in_ranks, torch.float32)
    n_in, ncols = plan.n_in, kron_cols(in_ranks)
    lib = _library()
    out = torch.zeros((plan.out_rows, cols_padded(ncols)), dtype=torch.float32, device=dev)

    def ints(xs):
        return (ctypes.c_int * n_in)(*xs)

    def ptr_array(ts):
        return (ctypes.c_void_p * n_in)(*(t.data_ptr() for t in ts))

    args = (plan.vals.data_ptr(), plan.iloc.data_ptr(), plan.block_it.data_ptr(),
            ptr_array(plan.in_locs), ptr_array(plan.block_in), ptr_array(factors_pad),
            ints(plan.in_tiles), ints(f.shape[1] for f in factors_pad), ints(in_ranks), n_in,
            plan.nblocks, plan.blk, plan.tile_i, out.shape[1], out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if n_in <= MAX_TEMPLATE_IN:
        err = launch_fn(lib, "ttmc_blocked_launch", _HEAD + LAUNCH_TAIL)(*args, dev.index, stream)
    else:
        table = wide_table(n_in, dev)
        err = launch_fn(lib, "ttmc_blocked_wide_launch", _HEAD + WIDE_LAUNCH_TAIL)(
            *args, table.data_ptr(), table.numel(), dev.index, stream)
    if err == -1:
        raise ValueError(f"ttmc_blocked: the wide path's digits of in_ranks {in_ranks} leave no "
                         f"room for a sorted slot in one CTA's shared-memory budget")
    if err != 0:
        raise RuntimeError(f"ttmc_blocked kernel launch failed: cudaError_t {err}")
    ttmc_blocked.launches += 1
    return out


ttmc_blocked.launches = 0
