"""Host-side per-iteration bookkeeping and argument contracts shared by the
drivers.  Counterpart of `finish_iter` (without the obs events),
`check_planned_method` and `check_workspace` in `repro.core.loop`, and of
the drivers' shared handling of given initial factors."""
from __future__ import annotations

import math
import warnings
from typing import Sequence

import numpy as np
import torch

__all__ = ["check_planned_method", "check_workspace", "finish_iter", "given_factors"]


def given_factors(init_factors: Sequence, shapes: Sequence[tuple[int, ...]],
                  device: torch.device, what: str = "factor") -> list[torch.Tensor]:
    """The caller's initial factors (or TT cores, `what="core"`: arrays or
    tensors, one per mode) as float32 tensors on `device`; raises unless
    factor m has shape shapes[m]."""
    if len(init_factors) != len(shapes):
        raise ValueError(f"{len(init_factors)} initial {what}s for a {len(shapes)}-mode tensor")
    out = []
    for m, (f, shape) in enumerate(zip(init_factors, shapes)):
        t = f if isinstance(f, torch.Tensor) else torch.tensor(np.asarray(f, np.float32))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"initial {what} {m} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        out.append(t.to(device=device, dtype=torch.float32))
    return out


def check_planned_method(method: str, planned) -> None:
    """A workspace serves only the planned path: raise where one is passed
    with another method, which would otherwise ignore it silently.  (The
    reference's check also names its sharded path, which the port does not
    have yet.)"""
    if planned is not None and method != "pallas":
        raise ValueError(
            f"a planned workspace was passed but method is {method!r}, not 'pallas'; "
            f"the workspace would be silently ignored")


def check_workspace(planned, cls: type, built_for: dict, device: torch.device) -> None:
    """Raise unless `planned` is a `cls` whose attributes equal the call's
    values in `built_for` (e.g. {"shape": ..., "rank": ...}) and whose plans
    live on `device`."""
    if not isinstance(planned, cls):
        raise ValueError(f"planned must be a {cls.__name__}, got {type(planned).__name__}")
    has = {k: getattr(planned, k) for k in built_for}
    if has != built_for:
        def fmt(d):
            return " ".join(f"{k}={v}" for k, v in d.items())
        raise ValueError(f"planned workspace does not match the call: built for {fmt(has)}, "
                         f"the call has {fmt(built_for)}")
    if planned.device != device:
        raise ValueError(f"planned workspace lives on {planned.device}, the call asks for {device}")


def finish_iter(fits, fit, it: int, tol, verbose: bool, label: str) -> bool:
    """Record the fit scalar (the loop's one device->host sync) and decide
    whether to stop: on a non-finite fit (with a RuntimeWarning), or when
    `tol` is given and the fit moved less than it since the last iteration."""
    fits.append(float(fit))
    if verbose:
        print(f"[{label}] iter {it:3d} fit={fits[-1]:.6f}")
    if not math.isfinite(fits[-1]):
        warnings.warn(
            f"[{label}] non-finite fit ({fits[-1]}) at iteration {it}; stopping early",
            RuntimeWarning,
            stacklevel=2,
        )
        return True
    return tol is not None and it > 0 and abs(fits[-1] - fits[-2]) < tol
