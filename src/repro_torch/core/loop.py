"""Host-side per-iteration bookkeeping and argument contracts shared by the
drivers.  Counterpart of `finish_iter`, `check_planned_method`,
`check_drive_extras` and `check_workspace` in `repro.core.loop`, and of
the drivers' shared handling of given initial factors.

The numerical guards of the resilience layer live here too (`GuardConfig`,
`GuardState`, `DecompositionDiverged`): divergence detection is host-side
bookkeeping of the fit scalar, consumed by `PlannedWorkspace.drive` and
re-exported from `repro_torch.resilience`."""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..obs import metrics as _metrics
from ..obs import trace as _trace

__all__ = [
    "check_drive_extras",
    "check_planned_method",
    "check_workspace",
    "finish_iter",
    "given_factors",
    "GuardConfig",
    "GuardState",
    "DecompositionDiverged",
]

GUARD_POLICIES = ("raise", "fallback", "restart")

#: A fit must drop this far below the best seen before an iteration counts
#: toward the divergence patience: convergence noise stays inert.
REGRESSION_TOL = 1e-6


class DecompositionDiverged(RuntimeError):
    """A guarded decomposition diverged and could not (or was not asked to)
    recover: which driver, at which iteration, why, and the fit history up
    to the failure.  The reference's message, to the character."""

    def __init__(self, label: str, iteration: int, reason: str, fit_history: list[float]):
        self.label = label
        self.iteration = iteration
        self.reason = reason
        self.fit_history = list(fit_history)
        super().__init__(
            f"[{label}] diverged at iteration {iteration}: {reason} "
            f"(fit history: {self._tail()})")

    def _tail(self) -> str:
        tail = self.fit_history[-4:]
        pre = "..., " if len(self.fit_history) > len(tail) else ""
        return "[" + pre + ", ".join(f"{f:.6g}" for f in tail) + "]"


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Numerical-guard policy for `PlannedWorkspace.drive`.

    policy: "raise" (raise `DecompositionDiverged`), "restart" (start over
      from jittered initial factors, at most `max_restarts` times) or
      "fallback" (switch the planned sweep to the format's plain reference
      sweep mid-run, on the same padded factors: the last good iterate).
    divergence_patience: consecutive regressing fits tolerated before the
      guard fires (a non-finite fit fires at once).
    max_restarts: restarts before "restart" escalates to raising.
    check_factors_every: if > 0, also check that the factors are finite
      every k iterations (one more host sync each time); 0 checks only the
      fit, which is synced every iteration anyway."""

    policy: str = "raise"
    divergence_patience: int = 3
    max_restarts: int = 2
    check_factors_every: int = 0

    def __post_init__(self):
        if self.policy not in GUARD_POLICIES:
            raise ValueError(f"unknown guard policy {self.policy!r}: expected one of {GUARD_POLICIES}")
        if self.divergence_patience < 1:
            raise ValueError("divergence_patience must be >= 1")
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if self.check_factors_every < 0:
            raise ValueError("check_factors_every must be >= 0")


class GuardState:
    """Host-side divergence tracker: `observe_fit` takes each iteration's
    fit and returns a reason string when the guard fires, else None.
    `reset()` clears the trajectory (after a restart or a fallback) but
    keeps the restart count."""

    def __init__(self, cfg: GuardConfig):
        self.cfg = cfg
        self.restarts = 0
        self.reset()

    def reset(self) -> None:
        self.best = -math.inf
        self.regress_streak = 0

    def observe_fit(self, fit: float) -> str | None:
        if not math.isfinite(fit):
            return f"non-finite fit ({fit})"
        if fit < self.best - REGRESSION_TOL:
            self.regress_streak += 1
            if self.regress_streak >= self.cfg.divergence_patience:
                return (f"fit regressed below best {self.best:.6g} for "
                        f"{self.regress_streak} consecutive iterations (latest {fit:.6g})")
        else:
            self.regress_streak = 0
            self.best = max(self.best, fit)
        return None


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


def check_planned_method(method: str, planned, devices=None, dist=None) -> None:
    """The argument contract of cp_als, tucker_hooi and tt_als: a workspace serves
    only the planned paths, and `devices=` / `dist=` only the sharded one;
    raise where either is passed with another method, which would
    otherwise ignore it silently."""
    if planned is not None and method not in ("pallas", "pallas_sharded"):
        raise ValueError(
            f"a planned workspace was passed but method is {method!r}, not 'pallas' or "
            f"'pallas_sharded'; the workspace would be silently ignored")
    if method != "pallas_sharded" and (devices is not None or dist is not None):
        raise ValueError(
            f"devices/dist apply only to method='pallas_sharded' (got method={method!r}); "
            f"they would be silently ignored")


def check_drive_extras(method: str, guards, checkpoint_every, checkpoint_path, *,
                       mttkrp_fn=None) -> None:
    """Guards and checkpoints are taken by the planned drive loop only:
    raise where they are passed to another method, or beside CP's
    `mttkrp_fn=` (which runs the per-mode loop, not the drive loop), rather
    than ignore them silently.  The port has no `jit_sweep=`; the
    reference folds `mttkrp_fn` into it."""
    if guards is None and checkpoint_every is None and checkpoint_path is None:
        return
    if method not in ("pallas", "pallas_sharded") or mttkrp_fn is not None:
        raise ValueError(
            "guards/checkpoint_every/checkpoint_path are consumed by the planned drive loop: "
            f"they require method='pallas' or 'pallas_sharded' without mttkrp_fn (got "
            f"method={method!r}{', mttkrp_fn' if mttkrp_fn is not None else ''}; they would be "
            f"silently ignored)")


def check_workspace(planned, cls: type, built_for: dict, device: torch.device | None = None, *,
                    method: str = "pallas", devices=None, dist=None) -> None:
    """Raise unless `planned` is a `cls` whose attributes equal the call's
    values in `built_for` (e.g. {"shape": ..., "rank": ...}) and that lives
    where the call asks: on `device` (the planned path), or on the shards
    `dist` or `devices` name (the sharded path; a count or a sequence of
    devices)."""
    if not isinstance(planned, cls):
        hint = ("" if method == "pallas_sharded"
                else " (use method='pallas_sharded' for sharded workspaces)")
        raise ValueError(f"method={method!r} needs a {cls.__name__} workspace, got "
                         f"{type(planned).__name__}{hint}")
    has = {k: getattr(planned, k) for k in built_for}
    if has != built_for:
        def fmt(d):
            return " ".join(f"{k}={v}" for k, v in d.items())
        raise ValueError(f"planned workspace does not match the call: built for {fmt(has)}, "
                         f"the call has {fmt(built_for)}")
    if device is not None and planned.device != device:
        raise ValueError(f"planned workspace lives on {planned.device}, the call asks for {device}")
    if dist is not None and planned.dist != dist:
        raise ValueError(f"planned workspace spans {[str(d) for d in planned.dist.devices]}, "
                         f"dist= asks for {[str(d) for d in dist.devices]}")
    if devices is not None:
        same = (planned.nshards == devices if isinstance(devices, int)
                else planned.dist.devices == tuple(resolve_device(d) for d in devices))
        if not same:
            raise ValueError(f"planned workspace spans {planned.nshards} shards on "
                             f"{[str(d) for d in planned.dist.devices]}, devices={devices!r} "
                             f"was requested")


def finish_iter(fits, fit, it: int, tol, verbose: bool, label: str) -> bool:
    """Record the fit scalar (the loop's one device->host sync) and decide
    whether to stop: on a non-finite fit (with a RuntimeWarning, the
    `resilience.nonfinite_fit` counter and a `nonfinite_fit` trace event),
    or when `tol` is given and the fit moved less than it since the last
    iteration."""
    fits.append(float(fit))
    if verbose:
        print(f"[{label}] iter {it:3d} fit={fits[-1]:.6f}")
    if not math.isfinite(fits[-1]):
        _metrics.counter("resilience.nonfinite_fit", label=label).inc()
        _trace.event("nonfinite_fit", label=label, it=it, fit=repr(fits[-1]))
        warnings.warn(
            f"[{label}] non-finite fit ({fits[-1]}) at iteration {it}; stopping early — "
            f"pass guards=GuardConfig(...) for raise/restart/fallback recovery",
            RuntimeWarning,
            stacklevel=2,
        )
        return True
    return tol is not None and it > 0 and abs(fits[-1] - fits[-2]) < tol
