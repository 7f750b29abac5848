"""Carry state between the reference package and the port, through numpy.

Nothing here imports the reference: its arrays arrive as numpy (e.g.
`np.asarray(jax_array)`, `dataclasses.asdict(plan)`), and the port's state
leaves as numpy.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.cp_als import CPState
from .core.remap import BlockPlan
from .kernels.workspace import _plan_device_arrays
from .tt.als import TTState
from .tucker.hooi import TuckerState

__all__ = ["factors_from_numpy", "cores_from_numpy", "plan_from_numpy", "cpstate_to_numpy",
           "tuckerstate_to_numpy", "ttstate_to_numpy"]


def factors_from_numpy(factors: Sequence[np.ndarray], device: str | torch.device) -> list[torch.Tensor]:
    """Factor matrices as float32 tensors on `device` (copies)."""
    return [torch.tensor(np.asarray(f, np.float32), device=device) for f in factors]


def cores_from_numpy(cores: Sequence[np.ndarray], device: str | torch.device) -> list[torch.Tensor]:
    """TT cores (rl, I, rr) as float32 tensors on `device` (copies)."""
    for k, c in enumerate(cores):
        if np.ndim(c) != 3:
            raise ValueError(f"core {k} has shape {np.shape(c)}; a TT core is (rl, I, rr)")
    return factors_from_numpy(cores, device)


def plan_from_numpy(fields: dict, device: str | torch.device) -> BlockPlan:
    """A reference `BlockPlan`'s fields (its dataclass fields, numpy arrays
    and python scalars) as the port's `BlockPlan` on `device`."""

    def arr(a, dtype):
        return torch.tensor(np.asarray(a, dtype))

    plan = BlockPlan(
        vals=arr(fields["vals"], np.float32),
        iloc=arr(fields["iloc"], np.int32),
        in_locs=tuple(arr(a, np.int32) for a in fields["in_locs"]),
        block_it=arr(fields["block_it"], np.int32),
        block_in=tuple(arr(a, np.int32) for a in fields["block_in"]),
        tile_i=int(fields["tile_i"]),
        in_tiles=tuple(int(t) for t in fields["in_tiles"]),
        blk=int(fields["blk"]),
        out_rows=int(fields["out_rows"]),
        in_rows=tuple(int(r) for r in fields["in_rows"]),
        mode=int(fields["mode"]),
        in_modes=tuple(int(m) for m in fields["in_modes"]),
        nnz=int(fields["nnz"]),
    )
    return _plan_device_arrays(plan, torch.device(device))


def cpstate_to_numpy(state: CPState) -> dict:
    """{"factors": [np.ndarray], "lam": np.ndarray, "fit_history": [float]}."""
    return {
        "factors": [f.detach().cpu().numpy() for f in state.factors],
        "lam": state.lam.detach().cpu().numpy(),
        "fit_history": [float(x) for x in state.fit_history],
    }


def tuckerstate_to_numpy(state: TuckerState) -> dict:
    """{"factors": [np.ndarray], "core": np.ndarray, "fit_history": [float]}."""
    return {
        "factors": [f.detach().cpu().numpy() for f in state.factors],
        "core": state.core.detach().cpu().numpy(),
        "fit_history": [float(x) for x in state.fit_history],
    }


def ttstate_to_numpy(state: TTState) -> dict:
    """{"cores": [np.ndarray], "fit_history": [float]}."""
    return {
        "cores": [c.detach().cpu().numpy() for c in state.cores],
        "fit_history": [float(x) for x in state.fit_history],
    }
