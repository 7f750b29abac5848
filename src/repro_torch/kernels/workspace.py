"""The `PlannedWorkspace` protocol: what a planned decomposition workspace
does that is not format-specific.  Counterpart of
`repro.kernels.workspace`, with its tracing and metrics but without
guards, fallback or checkpoints.

  * rank padding and device-resident factors (`pad_factors` /
    `unpad_factors` / `padded_rows` / `rank_pads`), parameterized by each
    mode's true lane width `lane_ranks`;
  * `drive` — the host loop: pad once, one sweep per iteration, the
    host-side tol early exit on the fit scalar, unpad at the end; traced
    as a `drive` span with one `sweep` span per iteration (carrying the
    PMS-predicted sweep time while a tracer is active) and recorded in the
    `drive.*` metrics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import torch

from ..core.loop import finish_iter
from ..core.remap import BlockPlan
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .mttkrp import pad_factor, rank_padded

__all__ = ["PlannedWorkspace"]


def _plan_device_arrays(plan: BlockPlan, device: torch.device) -> BlockPlan:
    """The plan with every array on `device`, in the flat contiguous layout
    the kernel reads (plans built by `plan_blocks` already are)."""

    def move(t: torch.Tensor) -> torch.Tensor:
        return t.to(device).contiguous()

    return dataclasses.replace(
        plan,
        vals=move(plan.vals),
        iloc=move(plan.iloc),
        in_locs=tuple(move(t) for t in plan.in_locs),
        block_it=move(plan.block_it),
        block_in=tuple(move(t) for t in plan.block_in),
    )


def _padded_rows_from(geoms: dict[int, Any], nmodes: int) -> tuple[int, ...]:
    """Row padding of each mode's factor: the largest padding any plan needs
    of it (its own plan's out_rows, and in_rows wherever it is an input)."""
    rows = []
    for m in range(nmodes):
        r = geoms[m].out_rows
        for g in geoms.values():
            for n, im in enumerate(g.in_modes):
                if im == m:
                    r = max(r, g.in_rows[n])
        rows.append(r)
    return tuple(rows)


class PlannedWorkspace:
    """Base of every planned workspace.

    Subclasses provide `shape`, `lane_ranks`, `_geoms()` and `sweep(facs,
    *args, first)`, which takes the padded factor tuple and returns (new
    padded factors, aux, fit).  Padding rows and lanes are exactly zero on
    entry and stay exactly zero, so grams and fits taken on the true slices
    see the true factors."""

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def lane_ranks(self) -> tuple[int, ...]:
        raise NotImplementedError

    @property
    def rank_pads(self) -> tuple[int, ...]:
        return tuple(rank_padded(r) for r in self.lane_ranks)

    @property
    def padded_rows(self) -> tuple[int, ...]:
        return _padded_rows_from(self._geoms(), self.nmodes)

    def _geoms(self) -> dict[int, Any]:
        raise NotImplementedError

    def sweep(self, facs, *args, first: bool = False):
        raise NotImplementedError

    def pad_factors(self, factors: Sequence[torch.Tensor]) -> tuple[torch.Tensor, ...]:
        """One pad per mode for the whole decomposition."""
        return tuple(
            pad_factor(f, rows, rp)
            for f, rows, rp in zip(factors, self.padded_rows, self.rank_pads)
        )

    def unpad_factors(self, padded: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return [f[:s, :r].clone() for f, s, r in zip(padded, self.shape, self.lane_ranks)]

    def drive(self, factors, args=(), *, iters: int, tol=None,
              verbose: bool = False, label: str = "decompose"):
        """Pad once, one sweep per iteration (the first with the
        first-iteration convention), stop early on `tol` or a non-finite
        fit, unpad.  Returns (true-shape factors, aux of the last sweep,
        fit history).

        Each sweep's span encloses the fit's transfer to the host, so it
        ends after the sweep's device work; `drive.iter_seconds` times the
        same interval."""
        fits: list[float] = []
        facs = self.pad_factors(factors)
        aux = None
        m_iter = _metrics.histogram("drive.iter_seconds", label=label)
        m_delta = _metrics.histogram("drive.fit_delta", label=label)
        m_count = _metrics.counter("drive.iterations", label=label)
        predicted_s = self._predicted_sweep_s() if _trace.active() is not None else None
        with _trace.span("drive", label=label, iters=iters, start=0):
            for it in range(iters):
                t_sweep = time.perf_counter()
                with _trace.span("sweep", label=label, it=it, predicted_s=predicted_s):
                    facs, aux, fit = self.sweep(facs, *args, first=(it == 0))
                    fit = float(fit)
                m_iter.observe(time.perf_counter() - t_sweep)
                m_count.inc()
                if fits:
                    m_delta.observe(fit - fits[-1])
                if finish_iter(fits, fit, it, tol, verbose, label):
                    break
        return self.unpad_factors(facs), aux, fits

    def _predicted_sweep_s(self) -> float | None:
        """PMS-predicted seconds of one sweep where the workspace has the
        `pms_estimates` hook (PlannedCPALS / PlannedTucker / PlannedTT):
        the sum of its modes' exact t_total; None otherwise.  Attached to
        traced sweep spans, so a trace alone carries what
        `obs.calibrate.join_trace` needs."""
        hook = getattr(self, "pms_estimates", None)
        if hook is None:
            return None
        return float(sum(e.t_total for e in hook().values()))
