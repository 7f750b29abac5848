"""Predicted-vs-achieved PMS accounting.

Counterpart of `repro.obs.calibrate` (its direct join; `accuracy_records`
waits for the bench and `join_trace` for the trace module).  It joins the
exact per-plan PMS predictions (`predict_from_plan` / `predict_ttmc` /
`predict_tt`, from the workspace's built BlockPlans) with measured sweep
times:

    achieved_pct = 100 * t_predicted / t_measured

100% means the sweep ran at the modelled roofline; far below means the
model is optimistic for that (format, config, tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

__all__ = [
    "pms_estimates",
    "predicted_sweep_seconds",
    "CalibrationRow",
    "calibration_row",
    "format_table",
]


def pms_estimates(ws: Any, spec=None) -> dict:
    """Per-mode exact PMS estimates of a planned workspace, through its
    `pms_estimates` hook (PlannedCPALS / PlannedTucker / PlannedTT).
    Raises TypeError for a workspace without the hook."""
    hook = getattr(ws, "pms_estimates", None)
    if hook is None:
        raise TypeError(f"{type(ws).__name__} exposes no pms_estimates() hook; "
                        f"calibration needs a planned workspace")
    return hook(spec) if spec is not None else hook()


def predicted_sweep_seconds(ws: Any, spec=None) -> float:
    """The PMS-predicted time of one sweep's kernels: the sum over output
    modes of each mode's exact t_total (the modes run one after another)."""
    return float(sum(e.t_total for e in pms_estimates(ws, spec).values()))


@dataclasses.dataclass(frozen=True)
class CalibrationRow:
    """One (format, preset) entry of the achieved-vs-predicted table."""

    format: str
    preset: str
    predicted_s: float
    measured_s: float

    @property
    def achieved_pct(self) -> float:
        return 100.0 * self.predicted_s / self.measured_s


def calibration_row(ws: Any, measured_s: float, *, format: str, preset: str,
                    spec=None) -> CalibrationRow:
    """Join one workspace's exact PMS prediction with a measured
    steady-state sweep time (seconds per sweep, warm-up excluded)."""
    if measured_s <= 0:
        raise ValueError(f"measured_s must be > 0, got {measured_s}")
    return CalibrationRow(format=format, preset=preset,
                          predicted_s=predicted_sweep_seconds(ws, spec),
                          measured_s=float(measured_s))


def format_table(rows: Sequence[Mapping]) -> str:
    """Plain-text achieved_pct table of rows with "label", "preset",
    "n_sweeps", "measured_s", "predicted_s" and "achieved_pct" (the last
    two may be None)."""
    header = (f"{'label':<14} {'preset':<10} {'sweeps':>6} "
              f"{'measured_s':>11} {'predicted_s':>12} {'achieved':>9}")
    lines = [header, "-" * len(header)]
    for r in rows:
        pred = r.get("predicted_s")
        ach = r.get("achieved_pct")
        pred_s = f"{pred:>12.3e}" if pred is not None else f"{'-':>12}"
        ach_s = f"{ach:>8.2f}%" if ach is not None else f"{'-':>9}"
        lines.append(
            f"{r['label']:<14} {r['preset']:<10} {r['n_sweeps']:>6d} "
            f"{r['measured_s']:>11.6f} {pred_s} {ach_s}"
        )
    return "\n".join(lines)
