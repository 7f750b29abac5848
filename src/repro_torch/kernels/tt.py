"""Blocked sorted-COO TT-core update on a BlockPlan: the wrapper of the
Hopper kernel (`csrc/ttcore.cu`) and its plain PyTorch version.

Counterpart of `repro.kernels.tt_pallas` (`ttcore_pallas_call`,
`tt_out_pair`, `tt_out_cols`).  For output mode m it computes the TT-ALS
right-hand side

    B[i_m, :] += v * kron(left, right)        (rl_m * rr_m columns)

over the plan's slots.  Each input is an interface matrix W_k =
transpose(G_k, (1, 0, 2)).reshape(I_k, rl_k * rr_k), whose element (a, b)
sits at lane a * rr_k + b.  `left` chains the gathered rows of the first
`n_left` inputs, ascending, as row vector times (rl, rr) matrix; `right`
chains the others, descending, as (rl, rr) matrix times column vector;
both start from a 1-vector.  Columns run row-major over (rl_m, rr_m).  Only
the true rl_k * rr_k lanes of each row are read.

`ttcore_blocked` launches the CUDA kernel for CUDA tensors and runs
`ttcore_blocked_plain` only for tensors on the CPU;
`ttcore_blocked.launches` counts kernel launches.  As for MTTKRP and TTMc,
the wrapper allocates the output zeroed: rows no non-zero reaches and padded
lanes are exactly 0, and plans of more than 4 input modes take the kernel's
wide path.
"""
from __future__ import annotations

import ctypes
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

__all__ = ["chain_left", "chain_right", "tt_out_cols", "tt_out_pair", "ttcore_blocked",
           "ttcore_blocked_plain"]

#: Slot-by-lane elements per step of the plain version: its gathers and
#: outputs grow with the widest interface row or output row.
PLAIN_ELEMS = 1 << 24


def tt_out_pair(in_rank_pairs: Sequence[tuple[int, int]], n_left: int) -> tuple[int, int]:
    """The output core's interface pair (rl_m, rr_m), recovered from the
    input pairs: rl_m is the last left-chain input's right bond (1 when the
    output is the first core), rr_m the first right-chain input's left bond
    (1 when it is the last)."""
    n_in = len(in_rank_pairs)
    rl = in_rank_pairs[n_left - 1][1] if n_left > 0 else 1
    rr = in_rank_pairs[n_left][0] if n_left < n_in else 1
    return (int(rl), int(rr))


def tt_out_cols(in_rank_pairs: Sequence[tuple[int, int]], n_left: int) -> int:
    """Number of true output columns: rl_m * rr_m."""
    rl, rr = tt_out_pair(in_rank_pairs, n_left)
    return rl * rr


def chain_left(left: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """One left-chain step: (n, rl) row vectors times (n, rl, rr) matrices
    -> (n, rr)."""
    return torch.bmm(left[:, None, :], rows)[:, 0]


def chain_right(rows: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """One right-chain step: (n, rl, rr) matrices times (n, rr) column
    vectors -> (n, rl)."""
    return torch.bmm(rows, right[:, :, None])[:, :, 0]


def _check(plan: BlockPlan, factors_pad: Sequence[torch.Tensor],
           in_rank_pairs: Sequence[tuple[int, int]], n_left: int,
           dtype: torch.dtype) -> tuple[tuple[int, int], ...]:
    """Raise on anything the kernel does not take; returns the pairs as ints.
    The pairs must be bonds >= 1 that chain: within the left inputs each
    right bond is the next left bond and the first left bond is 1, and the
    same for the right inputs read from the last (whose right bond is 1).
    Interface matrix n must hold at least rl_n * rr_n lanes."""
    pairs = tuple((int(a), int(b)) for a, b in in_rank_pairs)
    if len(pairs) != plan.n_in or any(a < 1 or b < 1 for a, b in pairs):
        raise ValueError(f"in_rank_pairs {pairs}: expected {plan.n_in} (rl, rr) pairs >= 1, "
                         f"one per input mode")
    if not 0 <= n_left <= plan.n_in:
        raise ValueError(f"n_left {n_left} out of range [0, {plan.n_in}]")
    left, right = pairs[:n_left], pairs[n_left:]
    bonds_l = [1] + [b for _, b in left]
    bonds_r = [a for a, _ in right] + [1]
    if [a for a, _ in left] != bonds_l[:-1] or [b for _, b in right] != bonds_r[1:]:
        raise ValueError(f"in_rank_pairs {pairs} with n_left={n_left} do not chain: the left "
                         f"inputs must run 1 -> ... and the right inputs ... -> 1 bond to bond")
    check_plan_args(plan, factors_pad, dtype, [a * b for a, b in pairs])
    return pairs


def ttcore_blocked_plain(plan: BlockPlan, factors_pad: Sequence[torch.Tensor],
                         in_rank_pairs: Sequence[tuple[int, int]], n_left: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather each slot's interface
    rows, slice them to their true rl * rr lanes, chain them into the left
    and right vectors, fold the value into the left one, take the Kronecker
    product and `index_add_` it into the output rows; in block-aligned steps
    of about `PLAIN_ELEMS` slot-lanes, sized by the widest gathered or
    output row (an unchunked pass at NELL-2 size would gather 107 M slots x
    256 lanes).  Padding slots are computed like any other (value 0 adds 0).

    Computes in the dtype of its inputs: float32 like the kernel, or float64
    (plan.vals and the matrices cast up) for a reference whose own rounding
    is negligible.  Returns (plan.out_rows, rank_padded(rl_m * rr_m))."""
    dtype = torch.float64 if plan.vals.dtype == torch.float64 else torch.float32
    pairs = _check(plan, factors_pad, in_rank_pairs, n_left, dtype)
    rl_m, rr_m = tt_out_pair(pairs, n_left)
    ncols = rl_m * rr_m
    out = torch.zeros((plan.out_rows, rank_padded(ncols)), dtype=dtype, device=plan.device)
    widest = max([ncols] + [a * b for a, b in pairs])
    step = max(1, PLAIN_ELEMS // (plan.blk * widest))
    for b0 in range(0, plan.nblocks, step):
        b1 = min(plan.nblocks, b0 + step)
        s0, s1 = b0 * plan.blk, b1 * plan.blk

        def rows(n):
            a, b = pairs[n]
            idx = _rows(plan.block_in[n][b0:b1], plan.in_locs[n][s0:s1], plan.in_tiles[n])
            return factors_pad[n].index_select(0, idx.flatten())[:, : a * b].reshape(-1, a, b)

        left = torch.ones((s1 - s0, 1), dtype=dtype, device=plan.device)
        for n in range(n_left):
            left = chain_left(left, rows(n))
        right = torch.ones((s1 - s0, 1), dtype=dtype, device=plan.device)
        for n in range(plan.n_in - 1, n_left - 1, -1):
            right = chain_right(rows(n), right)
        left = plan.vals[s0:s1, None] * left
        contrib = (left[:, :, None] * right[:, None, :]).reshape(s1 - s0, ncols)
        rows_out = _rows(plan.block_it[b0:b1], plan.iloc[s0:s1], plan.tile_i).flatten()
        out[:, :ncols].index_add_(0, rows_out, contrib)
    return out


def _library() -> ctypes.CDLL:
    from .build import load  # builds on first use, never at import

    return load("ttcore")


_VP, _PTRS, _INTS = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
#: The arguments both TT-core launches take first.
_HEAD = [_VP, _VP, _VP, _PTRS, _PTRS, _PTRS, _INTS, _INTS, _INTS, _INTS, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP]


#: The launch's return code when not even one slot's staged vectors fit
#: beside a one-row output tile in one CTA's shared memory.
_SMEM_TOO_SMALL = -1


def ttcore_blocked(plan: BlockPlan, factors_pad: Sequence[torch.Tensor],
                   in_rank_pairs: Sequence[tuple[int, int]], n_left: int) -> torch.Tensor:
    """TT-core right-hand side on `plan` with one padded interface matrix
    per input mode (plan.in_modes order; matrix n has >= plan.in_rows[n]
    rows and >= rl_n * rr_n columns, of which the first rl_n * rr_n are
    read).  `n_left` inputs chain from the left: for a TT sweep, the output
    mode.

    CUDA tensors launch the Hopper kernel on the current stream (one launch,
    counted); CPU tensors run `ttcore_blocked_plain`.  Any bonds and any
    tile_i run: the kernel sizes its steps and splits its output tile by
    rows from the shared-memory budget; plans of more than MAX_TEMPLATE_IN
    input modes take the wide path.  Returns
    (plan.out_rows, rank_padded(rl_m * rr_m)) float32, zero wherever no
    non-zero lands and in every padded lane."""
    dev = plan.vals.device
    if dev.type == "cpu":
        return ttcore_blocked_plain(plan, factors_pad, in_rank_pairs, n_left)
    if dev.type != "cuda":
        raise ValueError(f"ttcore_blocked runs on CUDA or CPU tensors, got {dev}")
    pairs = _check(plan, factors_pad, in_rank_pairs, n_left, torch.float32)
    n_in = plan.n_in
    lib = _library()
    out = torch.zeros((plan.out_rows, rank_padded(tt_out_cols(pairs, n_left))),
                      dtype=torch.float32, device=dev)

    def ints(xs):
        return (ctypes.c_int * n_in)(*xs)

    def ptr_array(ts):
        return (ctypes.c_void_p * n_in)(*(t.data_ptr() for t in ts))

    args = (plan.vals.data_ptr(), plan.iloc.data_ptr(), plan.block_it.data_ptr(),
            ptr_array(plan.in_locs), ptr_array(plan.block_in), ptr_array(factors_pad),
            ints(plan.in_tiles), ints(f.shape[1] for f in factors_pad), ints(a for a, _ in pairs),
            ints(b for _, b in pairs), n_in, n_left, plan.nblocks, plan.blk, plan.tile_i,
            out.shape[1], out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if n_in <= MAX_TEMPLATE_IN:
        err = launch_fn(lib, "ttcore_blocked_launch", _HEAD + LAUNCH_TAIL)(*args, dev.index, stream)
    else:
        table = wide_table(n_in, dev)
        err = launch_fn(lib, "ttcore_blocked_wide_launch", _HEAD + WIDE_LAUNCH_TAIL)(
            *args, table.data_ptr(), table.numel(), dev.index, stream)
    if err == _SMEM_TOO_SMALL:
        raise ValueError(
            f"ttcore_blocked: one slot's staged vectors of in_rank_pairs {pairs} "
            f"(n_left={n_left}) do not fit beside a one-row output tile in one CTA's "
            f"shared-memory budget")
    if err != 0:
        raise RuntimeError(f"ttcore_blocked kernel launch failed: cudaError_t {err}")
    ttcore_blocked.launches += 1
    return out


ttcore_blocked.launches = 0
