"""Fault injection for the resilience layer (`repro_torch.resilience`).
Counterpart of `repro.testing.faults`.

Each injector plants one failure the guards exist to catch, so tests can
check detection and recovery:

  * `inject_nan_factor`: a factor turns NaN after iteration k (caught by
    the fit guard at the next iteration, or by the factor check);
  * `corrupt_plan`: a BlockPlan with a local index out of its tile
    (caught by `validate_plan`);
  * `shrunk_budget`: a device-memory budget just under a workspace's
    footprint (the admission ladder steps down);
  * `kill_at`: the process dies before iteration k (checkpoint/resume, in
    a subprocess);
  * `deaden_shard`: one shard of a sharded workspace contributes nothing
    after iteration k (caught by the regression guard).

The iteration-indexed injectors fire once: a restart replays iterations
from 0, and a fault that fired on every attempt would exhaust any
`max_restarts`.  They wrap `ws._sweep_call`, which the drive loop binds
when it starts; the "fallback" policy switches to the reference sweep and
so sheds the wrapper.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

__all__ = ["inject_nan_factor", "corrupt_plan", "shrunk_budget", "deaden_shard", "kill_at"]


def inject_nan_factor(ws: Any, *, at_iter: int, mode: int | None = None) -> Any:
    """Arm `ws` so the sweep of iteration `at_iter` returns its factors with
    `facs[mode]` turned NaN.  That iteration's fit stays finite (the poison
    lands after the sweep), so the fit guard sees it at the next iteration
    and the factor check at this one.  Fires once.

    `mode` defaults to the last mode: ALS updates mode 0 first from the
    other factors, so a NaN mode-0 factor would be solved away unread."""
    tgt = (len(ws.shape) - 1) if mode is None else mode
    inner = ws._sweep_call
    state = {"fired": False}

    def wrapped(facs, *args, it: int):
        facs, aux, fit = inner(facs, *args, it=it)
        if it == at_iter and not state["fired"]:
            state["fired"] = True
            facs = list(facs)
            facs[tgt] = facs[tgt] * torch.nan
            facs = tuple(facs)
        return facs, aux, fit

    ws._sweep_call = wrapped
    return ws


def corrupt_plan(plan: Any) -> Any:
    """A copy of `plan` whose first local output index is one past its tile
    (`iloc[0] == tile_i`), which `validate_plan` must catch.  The original
    plan is untouched."""
    if plan.iloc.numel() == 0:
        raise ValueError("cannot corrupt an empty plan")
    iloc = plan.iloc.clone()
    iloc[0] = plan.tile_i
    return dataclasses.replace(plan, iloc=iloc)


def shrunk_budget(ws: Any, fraction: float = 0.5) -> int:
    """A budget under `ws`'s footprint (`fraction` of it, at least one byte
    short), which the admission check rejects."""
    from ..resilience import admission_bytes

    total = admission_bytes(ws)["total_bytes"]
    return min(int(total * fraction), total - 1)


def deaden_shard(ws: Any, *, shard: int, at_iter: int) -> Any:
    """Arm a sharded workspace so shard `shard`'s plans hold only zero
    values after the sweep of iteration `at_iter`: a silently dead device.
    Every later sweep loses that shard's part of each reduced output while
    the fit is still taken against the whole tensor, so the fit falls and
    the regression guard fires.  The dead plans replace the shard's plans
    in the workspace's stacks (the cached plans are untouched) and stay
    dead: a restart cannot revive them, so pair this with policy="raise"."""
    if not hasattr(ws, "stacks"):
        raise ValueError("deaden_shard needs a sharded workspace (no .stacks)")
    inner = ws._sweep_call
    state = {"fired": False}

    def wrapped(facs, *args, it: int):
        out = inner(facs, *args, it=it)
        if it == at_iter and not state["fired"]:
            state["fired"] = True
            for stack in ws.stacks.values():
                plans = list(stack.plans)
                plans[shard] = dataclasses.replace(plans[shard],
                                                   vals=torch.zeros_like(plans[shard].vals))
                stack.plans = tuple(plans)
        return out

    ws._sweep_call = wrapped
    return ws


def kill_at(ws: Any, *, at_iter: int, exit_code: int = 17) -> Any:
    """Arm `ws` so the process exits at once (`os._exit`: no atexit, no
    cleanup) before the sweep of iteration `at_iter`: checkpoints through
    iteration `at_iter - 1` survive, nothing later exists.  For subprocess
    tests of checkpoint/resume."""
    inner = ws._sweep_call

    def wrapped(facs, *args, it: int):
        if it == at_iter:
            os._exit(exit_code)
        return inner(facs, *args, it=it)

    ws._sweep_call = wrapped
    return ws
