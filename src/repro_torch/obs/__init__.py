"""repro_torch.obs: observability of the planned engine.

  * `obs.trace`: span/event tracing (`span("plan_build", mode=...)`
    context managers recorded into a thread-safe collector, exported as
    JSONL or Chrome-trace JSON, entered as `torch.profiler.record_function`
    ranges).  Off by default; enabled by ``REPRO_TORCH_TRACE=1`` (or a
    path), `trace.enable()`, or per call with ``decompose(..., trace=...)``.
    Disabled calls are no-ops.
  * `obs.metrics`: always-on counters, gauges and histograms (the port's
    own copy of the reference's registry): drive-loop iteration times and
    fit deltas, plan-build and padding/occupancy stats, plan-cache and
    autotune-cache hits and misses, non-finite fits.
  * `obs.calibrate`: the PMS's exact per-plan predictions joined with
    measured sweep times (`achieved_pct`), directly or from a trace.

This package imports nothing of the rest of `repro_torch` at module scope,
so every layer can record into it without cycles.
"""
from . import metrics, trace  # noqa: F401
from .trace import (  # noqa: F401
    Tracer,
    active,
    configure_from_env,
    disable,
    enable,
    event,
    install,
    span,
    tracing,
)

__all__ = [
    "metrics",
    "trace",
    "Tracer",
    "active",
    "configure_from_env",
    "disable",
    "enable",
    "event",
    "install",
    "span",
    "tracing",
]
