"""Blocked sorted-COO MTTKRP on a BlockPlan: the wrapper of the Hopper
kernel (`csrc/mttkrp.cu`) and its plain PyTorch version.

Counterpart of `repro.kernels.mttkrp_pallas` (`mttkrp_pallas_call`,
`pad_factor`, `rank_padded`).  `mttkrp_blocked` launches the CUDA kernel for
CUDA tensors and runs `mttkrp_blocked_plain` only for tensors on the CPU;
`mttkrp_blocked.launches` counts kernel launches.

Unlike the Pallas kernel, which leaves output tiles no block visits
undefined (the reference masks them afterwards), the wrapper allocates the
output zeroed, so every row no non-zero reaches is exactly 0.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..core.remap import BlockPlan

__all__ = ["check_plan_args", "mttkrp_blocked", "mttkrp_blocked_plain", "pad_factor", "rank_padded"]

#: Slots per step of the plain version (bounds its gather temporaries) ...
PLAIN_CHUNK = 1 << 24
#: ... and slot-by-lane elements per step, which binds for rows wider than 16.
PLAIN_ELEMS = 1 << 28


def rank_padded(rank: int) -> int:
    """Lane padding of a rank-R factor: R rounded up to a multiple of 4, so a
    row is a whole number of 16-byte segments.  (The reference pads to 128
    TPU lanes; padded lanes stay exactly 0 either way.)"""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    return ((rank + 3) // 4) * 4


def pad_factor(f: torch.Tensor, rows: int, rp: int) -> torch.Tensor:
    """Zero-pad a factor matrix to (rows, rp); padded rows and lanes are 0."""
    out = torch.zeros((rows, rp), dtype=f.dtype, device=f.device)
    out[: f.shape[0], : f.shape[1]] = f
    return out


def _rows(tile_ids: torch.Tensor, locs: torch.Tensor, tile: int) -> torch.Tensor:
    return tile_ids.to(torch.int64)[:, None] * tile + locs.to(torch.int64).view(tile_ids.shape[0], -1)


def mttkrp_blocked_plain(plan: BlockPlan, factors_pad: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather the input rows of every
    slot, multiply by the value, `index_add_` into the output rows; in
    block-aligned chunks of about `PLAIN_CHUNK` slots, fewer where rows
    are wider than `PLAIN_ELEMS / PLAIN_CHUNK` lanes.  Padding slots are
    computed like any other (value 0 times a finite row adds 0).

    Computes in the dtype of its inputs: float32 like the kernel, or float64
    (plan.vals and factors cast up) for a reference whose own rounding is
    negligible.  Returns (plan.out_rows, factor width)."""
    dtype = torch.float64 if plan.vals.dtype == torch.float64 else torch.float32
    _check(plan, factors_pad, dtype)
    ld = factors_pad[0].shape[1]
    out = torch.zeros((plan.out_rows, ld), dtype=dtype, device=plan.device)
    step = max(1, min(PLAIN_CHUNK // plan.blk, PLAIN_ELEMS // (plan.blk * ld)))
    for b0 in range(0, plan.nblocks, step):
        b1 = min(plan.nblocks, b0 + step)
        s0, s1 = b0 * plan.blk, b1 * plan.blk
        contrib = plan.vals[s0:s1, None]
        for f, tids, locs, tile in zip(factors_pad, plan.block_in, plan.in_locs, plan.in_tiles):
            rows = _rows(tids[b0:b1], locs[s0:s1], tile).flatten()
            contrib = contrib * f.index_select(0, rows)
        rows = _rows(plan.block_it[b0:b1], plan.iloc[s0:s1], plan.tile_i).flatten()
        out.index_add_(0, rows, contrib)
    return out


def check_plan_args(plan: BlockPlan, factors_pad: Sequence[torch.Tensor], dtype: torch.dtype,
                    min_cols: Sequence[int]) -> None:
    """Raise on a plan stream or padded factors that the blocked kernels do
    not take: 2-4 input modes; every stream array contiguous, on the plan's
    device, of the layout's dtype and shape (values of `dtype`, float32 for
    the kernels); one 2-D contiguous `dtype` factor per input mode with at
    least plan.in_rows[n] rows and min_cols[n] columns.  Shared by every
    kernel wrapper on the BlockPlan layout, so all reject the same plans."""
    n_in = plan.n_in
    if not 2 <= n_in <= 4:
        raise ValueError(f"the kernel takes 2-4 input modes (3-5-mode tensors), got {n_in}")
    if len(factors_pad) != n_in:
        raise ValueError(f"{len(factors_pad)} factors for {n_in} input modes")
    total = plan.nblocks * plan.blk
    dev = plan.vals.device
    stream = [("vals", plan.vals, dtype, (total,)),
              ("iloc", plan.iloc, torch.int32, (total,)),
              ("block_it", plan.block_it, torch.int32, (plan.nblocks,))]
    for n in range(n_in):
        stream += [(f"in_locs[{n}]", plan.in_locs[n], torch.int32, (total,)),
                   (f"block_in[{n}]", plan.block_in[n], torch.int32, (plan.nblocks,))]
    for name, t, want, shape in stream:
        if t.device != dev or t.dtype != want or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"plan.{name}: expected a contiguous {want} tensor of shape {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    for n, (f, cols) in enumerate(zip(factors_pad, min_cols)):
        cols = max(cols, 1)
        if (f.device != dev or f.dtype != dtype or f.dim() != 2 or f.shape[0] < plan.in_rows[n]
                or f.shape[1] < cols or not f.is_contiguous()):
            raise ValueError(
                f"factor {n}: expected a contiguous {dtype} (>= {plan.in_rows[n]}, >= {cols}) "
                f"matrix on {dev}, got {f.dtype} {tuple(f.shape)} on {f.device}"
                f"{'' if f.is_contiguous() else ' (not contiguous)'}")


def _check(plan: BlockPlan, factors_pad: Sequence[torch.Tensor], dtype: torch.dtype) -> None:
    """`check_plan_args`, and one width for every factor: the kernel reads
    every factor and the output with one row stride."""
    ld = factors_pad[0].shape[1] if factors_pad and factors_pad[0].dim() == 2 else 1
    check_plan_args(plan, factors_pad, dtype, (ld,) * len(factors_pad))
    for n, f in enumerate(factors_pad):
        if f.shape[1] != ld:
            raise ValueError(f"factor {n}: {f.shape[1]} columns, factor 0 has {ld}; "
                             f"every factor takes one width")


def _library() -> ctypes.CDLL:
    from .build import load  # builds on first use, never at import

    lib = load("mttkrp")
    if lib.mttkrp_blocked_launch.argtypes is None:
        vp, ptrs = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        lib.mttkrp_blocked_launch.argtypes = [
            vp, vp, vp, ptrs, ptrs, ptrs, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, ctypes.c_int, vp]
        lib.mttkrp_blocked_launch.restype = ctypes.c_int
    return lib


def mttkrp_blocked(plan: BlockPlan, factors_pad: Sequence[torch.Tensor]) -> torch.Tensor:
    """MTTKRP on `plan` with one padded factor per input mode (plan.in_modes
    order, each with >= plan.in_rows[n] rows and one shared width).

    CUDA tensors launch the Hopper kernel on the current stream (and count
    one launch); CPU tensors run `mttkrp_blocked_plain`.  Any tile_i and
    width run: the kernel splits a tile of more than 4,096 rows into row
    parts, and a row of more than 1,024 columns into column slices.  Raises
    RuntimeError if the launch fails.  Returns (plan.out_rows, factor width)
    float32, zero wherever no non-zero lands."""
    dev = plan.vals.device
    if dev.type == "cpu":
        return mttkrp_blocked_plain(plan, factors_pad)
    if dev.type != "cuda":
        raise ValueError(f"mttkrp_blocked runs on CUDA or CPU tensors, got {dev}")
    _check(plan, factors_pad, torch.float32)
    n_in, ld = plan.n_in, factors_pad[0].shape[1]
    lib = _library()
    out = torch.zeros((plan.out_rows, ld), dtype=torch.float32, device=dev)

    def ptr_array(ts):
        return (ctypes.c_void_p * n_in)(*(t.data_ptr() for t in ts))

    err = lib.mttkrp_blocked_launch(
        plan.vals.data_ptr(), plan.iloc.data_ptr(), plan.block_it.data_ptr(),
        ptr_array(plan.in_locs), ptr_array(plan.block_in), ptr_array(factors_pad),
        (ctypes.c_int * n_in)(*plan.in_tiles), n_in, plan.nblocks, plan.blk,
        plan.tile_i, ld, out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mttkrp_blocked kernel launch failed: cudaError_t {err}")
    mttkrp_blocked.launches += 1
    return out


mttkrp_blocked.launches = 0
