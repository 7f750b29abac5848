"""repro_torch.tune: measured-roofline calibration and the persistent
autotune cache (counterpart of `repro.tune`).

`calibrate` fits a `GPUSpec` to the card from microbenchmarks and
block-sweep timings; `cache` persists the fitted spec and winning PMS
configurations across processes.  `pms.search(spec="measured")` and
`decompose(..., auto_tune="cached")` are the two consumer entry points.
"""
from .cache import (
    SCHEMA_VERSION,
    AutotuneCache,
    cache_dir,
    cache_path,
    cached_config,
    config_key,
    current_backend,
    default_cache,
    spec_fingerprint,
)
from .calibrate import (
    DEFAULT_CALIBRATION_CFGS,
    CalibSample,
    CalibrationResult,
    calibrate,
    calibrate_and_store,
    fit_spec,
    l2_bytes,
    measure_hbm_bw,
    measure_peak_flops_f32,
    predicted_seconds,
    resolve_spec,
    roofline_counts,
    sweep_sample,
)

__all__ = [
    "SCHEMA_VERSION",
    "AutotuneCache",
    "cache_dir",
    "cache_path",
    "cached_config",
    "config_key",
    "current_backend",
    "default_cache",
    "spec_fingerprint",
    "DEFAULT_CALIBRATION_CFGS",
    "CalibSample",
    "CalibrationResult",
    "calibrate",
    "calibrate_and_store",
    "fit_spec",
    "measure_hbm_bw",
    "measure_peak_flops_f32",
    "predicted_seconds",
    "resolve_spec",
    "roofline_counts",
    "l2_bytes",
    "sweep_sample",
]
