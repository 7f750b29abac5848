"""Host-side per-iteration bookkeeping shared by the drive loops.
Counterpart of `finish_iter` in `repro.core.loop`, without the obs events."""
from __future__ import annotations

import math
import warnings

__all__ = ["finish_iter"]


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
