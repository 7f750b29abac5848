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
from .core.memctrl import MemoryControllerConfig, config_from_dict
from .core.remap import BlockPlan
from .kernels.workspace import _plan_device_arrays
from .tt.als import TTState
from .tucker.hooi import TuckerState

__all__ = ["factors_from_numpy", "cores_from_numpy", "plan_from_numpy", "config_from_reference",
           "cpstate_to_numpy", "tuckerstate_to_numpy", "ttstate_to_numpy"]

#: Fields of the reference's configuration that only its TPU VMEM model
#: reads (resident factor tiles, double buffering); the port's kernels
#: have no counterpart.
_TPU_ONLY_FIELDS = {"cache": ("resident_tiles",), "dma": ("buffers",)}


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


def config_from_reference(d: dict) -> MemoryControllerConfig:
    """The reference's `config_to_dict` payload (a plain nested dict) as the
    port's `MemoryControllerConfig`: the same tiles, blk and Remapper
    widths, less the fields only the TPU's VMEM model reads.  Raises
    ValueError on any other field the port does not know."""
    if not isinstance(d, dict):
        raise ValueError(f"config: expected a dict, got {type(d).__name__}")
    ours = {k: ({f: x for f, x in v.items() if f not in _TPU_ONLY_FIELDS.get(k, ())}
                if isinstance(v, dict) else v)
            for k, v in d.items()}
    return config_from_dict(ours)


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
