"""spMTTKRP compute pattern on the raw COO stream (paper Alg. 3), plain
PyTorch.  Counterpart of `repro.core.mttkrp`; these are references, not
kernels — the planned kernel lives in `repro_torch.kernels.mttkrp`.

    out[i_m, :] += x * prod_{n != m} F_n[i_n, :]
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["hadamard_rows", "mttkrp_approach1"]


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


def mttkrp_approach1(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    out_rows: int,
) -> torch.Tensor:
    """Output-direction MTTKRP: Hadamard rows summed into their output rows
    with `index_add_` (the stream need not be sorted)."""
    contrib = hadamard_rows(indices, values, factors, mode)
    out = torch.zeros((out_rows, contrib.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, indices[:, mode], contrib)
