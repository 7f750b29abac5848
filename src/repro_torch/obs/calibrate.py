"""Predicted-vs-achieved PMS accounting.

Counterpart of `repro.obs.calibrate`.  It joins the exact per-plan PMS
predictions (`predict_from_plan` / `predict_ttmc` / `predict_tt`, from the
workspace's built BlockPlans) with measured sweep times, given directly (`calibration_row`) or read from a
trace's `sweep` spans, which carry the prediction (`join_trace`):

    achieved_pct = 100 * t_predicted / t_measured

100% means the sweep ran at the modelled roofline; far below means the
model is optimistic for that (format, config, tensor).  `accuracy_records`
renders the rows as benchmark result records (`repro_torch.bench`).
"""
from __future__ import annotations

import dataclasses
import statistics
from pathlib import Path
from typing import Any, Mapping, Sequence

__all__ = [
    "pms_estimates",
    "predicted_sweep_seconds",
    "CalibrationRow",
    "calibration_row",
    "accuracy_records",
    "join_trace",
    "format_table",
]


def pms_estimates(ws: Any, spec=None) -> dict:
    """Per-mode exact PMS estimates of a planned workspace, through its
    `pms_estimates` hook (PlannedCPALS / PlannedTucker / PlannedTT).
    Raises TypeError for a workspace without the hook, a sharded one among
    them (its shards are priced by `core.pms.predict_sharded`)."""
    hook = getattr(ws, "pms_estimates", None)
    if hook is None:
        raise TypeError(f"{type(ws).__name__} exposes no pms_estimates() hook; "
                        f"calibration needs a single-device planned workspace")
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


def accuracy_records(rows: Sequence[CalibrationRow]) -> list[dict]:
    """Calibration rows as benchmark result records (`pms_accuracy_<format>`:
    predicted_s, measured_s, achieved_pct; schema `repro_torch.bench`)."""
    from ..bench import result_record

    out = []
    for r in rows:
        name = f"pms_accuracy_{r.format}"
        out += [
            result_record(name, r.preset, "predicted_s", r.predicted_s, "s"),
            result_record(name, r.preset, "measured_s", r.measured_s, "s"),
            result_record(name, r.preset, "achieved_pct", r.achieved_pct, "%"),
        ]
    return out


def _steady_state_s(durs_us: Sequence[float]) -> float:
    """Median sweep duration in seconds, excluding the first sweep when more
    than one was recorded (the first pays the kernels' build and load and
    the first-iteration convention)."""
    steady = list(durs_us[1:]) if len(durs_us) > 1 else list(durs_us)
    return statistics.median(steady) / 1e6


def join_trace(path: str | Path | Sequence[Mapping]) -> list[dict]:
    """The offline join: group a trace's "sweep" spans by (label, preset)
    and compute achieved_pct where the spans carry `predicted_s`.

    Accepts a JSONL path or pre-loaded records.  Returns one dict per group:
    ``{"label", "preset", "n_sweeps", "measured_s", "predicted_s",
    "achieved_pct"}``; the last two are None for spans without a prediction
    (the workspace had no PMS hook)."""
    if isinstance(path, (str, Path)):
        from .trace import load_jsonl

        records: Sequence[Mapping] = load_jsonl(path)
    else:
        records = path
    groups: dict[tuple, dict] = {}
    for r in records:
        if r.get("ph") != "X" or r.get("name") != "sweep":
            continue
        args = r.get("args", {})
        key = (str(args.get("label", "?")), str(args.get("preset", "?")))
        g = groups.setdefault(key, {"durs": [], "predicted": None})
        g["durs"].append(float(r.get("dur", 0.0)))
        if args.get("predicted_s") is not None:
            g["predicted"] = float(args["predicted_s"])
    rows = []
    for (label, preset), g in sorted(groups.items()):
        measured = _steady_state_s(g["durs"])
        pred = g["predicted"]
        rows.append({
            "label": label,
            "preset": preset,
            "n_sweeps": len(g["durs"]),
            "measured_s": measured,
            "predicted_s": pred,
            "achieved_pct": 100.0 * pred / measured if pred and measured > 0 else None,
        })
    return rows


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
