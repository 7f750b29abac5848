"""Calibration CLI of the PyTorch port: fit the card's GPUSpec and warm the
autotune cache.

  PYTHONPATH=src python scripts/torch_calibrate.py [options]

Runs the port's measured-roofline calibration (repro_torch.tune.calibrate):
the microbenchmarks on the card (a device-to-device copy's rate and a
float32 matmul's), one block-sweep sample per calibration configuration, a
least-squares fit of (hbm_bw, peak_flops_f32, l2_bw), the
`obs.calibrate` validation join, and the fitted spec stored in the port's
autotune cache, after which `pms.search(spec="measured")` and
`decompose(spec="measured")` price configurations with the card's own
rates.

Options:
  --preset NAME     frostt_like preset for the sweep samples (default: tiny)
  --rank R          CP rank of the calibration sweeps (default: 8)
  --reps N          timed repetitions per sample (default: 2)
  --cache-dir PATH  use PATH in place of $REPRO_TORCH_AUTOTUNE_DIR for this run
  --dry-run         fit and report, but do not write the cache
  --check-hit       after fitting, check that a warm `spec="measured"`
                    resolve serves the stored spec without calibrating
                    again; exits non-zero on a miss
  --device DEV      torch device (default: CUDA; raises without a GPU).  On
                    the CPU the microbenchmarks are skipped and the fit
                    rests on the sweeps alone.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


@contextlib.contextmanager
def _env(name: str, value: str | None):
    """`os.environ[name] = value` for the block (unchanged where None)."""
    old = os.environ.get(name)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        if value is not None:
            if old is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = old


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--check-hit", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA; 'cpu' to run there)")
    return ap.parse_args(argv)


def main(argv=None, out: dict | None = None) -> int:
    """Run the calibration; `out`, where given, receives the
    `CalibrationResult` ("result"), the cache file ("cache_path") and with
    --check-hit the spec lookups of the check ("check_hit": hits, misses)."""
    a = parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.tune import (cache_path, calibrate, calibrate_and_store, current_backend, default_cache,
                                  resolve_spec)

    dev = resolve_device(a.device)
    with _env("REPRO_TORCH_AUTOTUNE_DIR", a.cache_dir):
        kwargs = dict(preset=a.preset, rank=a.rank, reps=a.reps, device=dev, microbench=dev.type == "cuda")
        result = calibrate(**kwargs) if a.dry_run else calibrate_and_store(**kwargs)
        if out is not None:
            out.update(result=result, cache_path=None if a.dry_run else cache_path())
        spec = result.spec
        print(f"backend: {result.backend}")
        if result.stream_hbm_bw is not None:
            print(f"microbench: stream bw {result.stream_hbm_bw/1e9:.2f} GB/s, "
                  f"matmul {result.matmul_peak_flops_f32/1e9:.1f} GFLOP/s (f32)")
        print(f"fitted: hbm_bw {spec.hbm_bw/1e9:.3f} GB/s, peak_flops_f32 {spec.peak_flops_f32/1e9:.1f} GFLOP/s "
              f"(sum-model residual {result.residual_rel:.1%})")
        print("validation (obs.calibrate achieved_pct, default -> measured):")
        for row in result.validation:
            print(f"  {row['label']:32s} {row['achieved_pct_default']:10.4f}% -> "
                  f"{row['achieved_pct_measured']:7.2f}%")
        if a.dry_run:
            print("dry run: cache not written")
            return 0
        print(f"stored -> {cache_path()} (backend {result.backend!r})")
        if a.check_hit:
            # The warm path: the spec comes back from the cache, not from a
            # fresh calibration (a resolve that missed would raise here).
            before = _spec_lookups()
            if default_cache().get_spec(result.backend) != spec:
                print("check-hit FAILED: cached spec does not match the fit", file=sys.stderr)
                return 1
            if result.backend == current_backend() and resolve_spec("measured", calibrate_on_miss=False) != spec:
                print("check-hit FAILED: spec='measured' does not resolve to the fit", file=sys.stderr)
                return 1
            lookups = {k: v - before[k] for k, v in _spec_lookups().items()}
            if out is not None:
                out["check_hit"] = lookups
            print(f"check-hit OK: warm spec='measured' resolves from the cache ({lookups['spec_hits']:.0f} hits, "
                  f"{lookups['spec_misses']:.0f} misses)")
    return 0


def _spec_lookups() -> dict:
    """The autotune cache's spec hits and misses so far in this process."""
    from repro_torch.obs import metrics

    counters = metrics.snapshot()["counters"]
    return {kind: sum(v for k, v in counters.items() if k.startswith(f"autotune_cache.{kind}"))
            for kind in ("spec_hits", "spec_misses")}


if __name__ == "__main__":
    raise SystemExit(main())
