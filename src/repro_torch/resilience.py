"""repro_torch.resilience: the failure story of the planned decomposition
engine.  Counterpart of `repro.resilience`.

  * **Numerical guards** (`GuardConfig`, policies "raise", "restart" and
    "fallback"), consumed by `PlannedWorkspace.drive`: a non-finite fit is
    caught for free (the fit scalar is synced every iteration anyway), a
    sustained regression after `divergence_patience` iterations, and
    non-finite factors on an opt-in cadence.  The drive loop then raises
    `DecompositionDiverged`, restarts from jittered initial factors (at
    most `max_restarts` times), or switches to the format's plain
    reference sweep on the same padded factors.  No guard catches an
    exception from a kernel's build or launch.
  * **Plan validation** (`validate_plan`, `PlanValidationError`,
    `plans_validated`, from `core.remap`): every BlockPlan invariant, at
    build time and on plan-cache hits under `REPRO_VALIDATE_PLANS=1`.
  * **Device-memory admission** (`admission_bytes`, `admit`,
    `plan_with_budget`, `AdmissionError`): a workspace's footprint is its
    layouts (`plan_bytes()`), its padded factors and the shared memory
    per CTA of its widest kernel launch (`smem_model_bytes()`, where the
    reference counts VMEM; the report's key is `smem_bytes`).
    `plan_with_budget` is the ladder behind `decompose(...,
    hbm_budget=...)`: halve the block size (less group padding, smaller
    layouts) down to `FLOOR_BLK`, then take the reference path, and only
    then raise `AdmissionError`.  The plan build's own temporaries are not
    in the report, as in the reference.
  * **Checkpoint/resume** rides on `drive(checkpoint_every=,
    checkpoint_path=)` and `train.checkpoint.CheckpointManager`.

The fault injectors that show each guard firing are in
`repro_torch.testing.faults`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .core.loop import (  # noqa: F401  (re-exports: the guard surface)
    DecompositionDiverged,
    GuardConfig,
    GuardState,
)
from .core.memctrl import MemoryControllerConfig
from .core.remap import (  # noqa: F401  (re-exports: the validation surface)
    PlanValidationError,
    plans_validated,
    validate_plan,
)
from .obs import metrics as _metrics
from .obs import trace as _trace

__all__ = [
    "GuardConfig",
    "GuardState",
    "DecompositionDiverged",
    "PlanValidationError",
    "validate_plan",
    "plans_validated",
    "FLOOR_BLK",
    "AdmissionError",
    "admission_bytes",
    "admit",
    "reference_footprint_bytes",
    "plan_with_budget",
]

#: The admission ladder never takes the block size below this.
FLOOR_BLK = 8


class AdmissionError(RuntimeError):
    """No rung of the ladder fits the budget, not even the reference path's
    raw stream and true factors.  Carries the rungs tried."""

    def __init__(self, budget_bytes: int, ladder: list[dict], reference_bytes: int):
        self.budget_bytes = budget_bytes
        self.ladder = list(ladder)
        self.reference_bytes = reference_bytes
        tried = ", ".join(f"blk={a['blk']}: {a['total_bytes']:,}B" for a in ladder) or "none"
        super().__init__(
            f"no configuration fits hbm_budget={budget_bytes:,}B — planned rungs tried "
            f"[{tried}]; reference path needs {reference_bytes:,}B")


def admission_bytes(ws: Any) -> dict:
    """A planned workspace's footprint: its layouts (`plan_bytes()`), its
    padded float32 factors, and the shared memory per CTA of its widest
    kernel launch (`smem_model_bytes()`)."""
    plan = int(ws.plan_bytes())
    fac = int(sum(rows * rp * 4 for rows, rp in zip(ws.padded_rows, ws.rank_pads)))
    smem = int(ws.smem_model_bytes())
    return {"plan_bytes": plan, "factor_bytes": fac, "smem_bytes": smem,
            "total_bytes": plan + fac + smem}


def admit(ws: Any, budget_bytes: int) -> dict:
    """The `admission_bytes` report where it fits `budget_bytes`; raises
    `AdmissionError` otherwise (no ladder: see `plan_with_budget`)."""
    report = admission_bytes(ws)
    if report["total_bytes"] > budget_bytes:
        _metrics.counter("admission.rejected").inc()
        _trace.event("admission_rejected", total_bytes=report["total_bytes"],
                     budget_bytes=int(budget_bytes))
        raise AdmissionError(budget_bytes, [{"blk": None, **report}], report["total_bytes"])
    _metrics.counter("admission.admitted", outcome="pallas").inc()
    return report


def reference_footprint_bytes(st: Any, lane_ranks) -> int:
    """What the reference (non-planned) path holds: the raw COO stream (an
    int32 coordinate per mode and a float32 value per non-zero) and the
    true-shape float32 factors; the ladder's last rung."""
    stream = st.nnz * (st.nmodes + 1) * 4
    facs = sum(s * int(r) * 4 for s, r in zip(st.shape, lane_ranks))
    return int(stream + facs)


def plan_with_budget(
    build: Callable[[MemoryControllerConfig], Any],
    budget_bytes: int,
    *,
    cfg: MemoryControllerConfig | None = None,
    floor_blk: int = FLOOR_BLK,
    reference_bytes: int = 0,
) -> tuple[Any, dict]:
    """The ladder of `decompose(..., hbm_budget=...)`: `build(cfg)` a
    workspace and check its `admission_bytes` total; while over budget,
    halve `cfg.dma.blk` down to `floor_blk` and build again; then take
    the reference path where `reference_bytes` fits; else raise
    `AdmissionError`.  Traced as an `admission_ladder` span with one
    `admission_rung` event per rung (and `admission_rejected`).

    Returns (workspace, decision): the workspace is None where the caller
    takes the reference path; the decision records the admitted rung and
    every rung tried."""
    cfg = cfg if cfg is not None else MemoryControllerConfig()
    attempts: list[dict] = []
    with _trace.span("admission_ladder", budget_bytes=int(budget_bytes)):
        while True:
            ws = build(cfg)
            report = admission_bytes(ws)
            attempts.append({"blk": cfg.dma.blk, **report})
            if report["total_bytes"] <= budget_bytes:
                _metrics.counter("admission.admitted", outcome="pallas").inc()
                _metrics.histogram("admission.ladder_rungs").observe(len(attempts))
                _trace.event("admission_rung", outcome="pallas", blk=cfg.dma.blk,
                             total_bytes=report["total_bytes"], rung=len(attempts))
                return ws, {"admitted": "pallas", "blk": cfg.dma.blk, "report": report,
                            "ladder": attempts}
            _trace.event("admission_rung", outcome="over_budget", blk=cfg.dma.blk,
                         total_bytes=report["total_bytes"], rung=len(attempts))
            del ws  # its layouts leave the device before the next rung is built
            if cfg.dma.blk // 2 >= floor_blk:
                cfg = dataclasses.replace(cfg, dma=dataclasses.replace(cfg.dma, blk=cfg.dma.blk // 2))
                continue
            break
        if reference_bytes <= budget_bytes:
            _metrics.counter("admission.admitted", outcome="reference").inc()
            _metrics.histogram("admission.ladder_rungs").observe(len(attempts) + 1)
            _trace.event("admission_rung", outcome="reference", total_bytes=int(reference_bytes),
                         rung=len(attempts) + 1)
            return None, {"admitted": "reference", "report": {"total_bytes": int(reference_bytes)},
                          "ladder": attempts}
        _metrics.counter("admission.rejected").inc()
        _trace.event("admission_rejected", budget_bytes=int(budget_bytes), rungs=len(attempts))
    raise AdmissionError(budget_bytes, attempts, int(reference_bytes))
