"""repro_torch.obs: observability of the planned engine.

  * `obs.metrics`: always-on counters, gauges and histograms (the port's
    own copy of the reference's registry);
  * `obs.calibrate`: the PMS's exact per-plan predictions joined with
    measured sweep times (`achieved_pct`).

Tracing (`repro.obs.trace`) is not ported yet.  This package imports
nothing of the rest of `repro_torch` at module scope, so every layer can
record into it without cycles.
"""
from . import metrics  # noqa: F401

__all__ = ["metrics"]
