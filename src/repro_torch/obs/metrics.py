"""Metrics registry: counters / gauges / histograms for the planned engine.

The port's own copy of `repro.obs.metrics` (stdlib only).  So far the PMS
(`pms.configs_evaluated`, `pms.searches`) and the autotune cache
(`autotune_cache.{hits,misses,spec_hits,spec_misses}`) record here.

Stdlib-only and always-on: unlike spans (obs.trace), metric updates are a
dict lookup plus an integer/float update under a small lock, cheap enough
for every hot path that wants one — the drive loop's per-iteration wall
time, the Tensor Remapper's plan-build stats, the plan cache's hit/miss
latencies, the resilience layer's guard/admission events.

Series are keyed by (metric name, sorted label items), Prometheus-style:

    from repro_torch.obs import metrics
    metrics.counter("plan_cache.hits", kind="mttkrp").inc()
    metrics.histogram("drive.iter_seconds", label="cp_als").observe(dt)
    metrics.snapshot()["histograms"]["drive.iter_seconds{label=cp_als}"]

`snapshot()` renders everything to plain dicts (JSON-ready); `reset()`
clears the default registry (tests isolate themselves with it).  Histograms
keep running count/sum/min/max plus a bounded sample of the first
`Histogram.SAMPLE_CAP` observations for percentile estimates — enough for
the per-iteration and per-build distributions this repo records, without
unbounded growth on long runs.
"""
from __future__ import annotations

import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "reset",
]


class Counter:
    """Monotonically increasing count (guard firings, cache hits, ...)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar (resident bytes, shard makespan, ...)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = None

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Streaming distribution: running count/sum/min/max plus a bounded
    sample (the first SAMPLE_CAP observations) for percentile estimates."""

    SAMPLE_CAP = 4096

    __slots__ = ("_lock", "count", "total", "vmin", "vmax", "sample")

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self.sample: list[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)
            if len(self.sample) < self.SAMPLE_CAP:
                self.sample.append(v)

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile over the retained sample (q in [0, 100])."""
        with self._lock:
            s = sorted(self.sample)
        if not s:
            return None
        rank = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        return s[rank]

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin,
            "max": self.vmax,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
        }


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Thread-safe get-or-create store of metric series.  A series' type is
    fixed by its first registration; re-registering the same series name
    with a different type raises (catches accidental name collisions)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, labels: dict):
        key = _series_key(name, labels)
        with self._lock:
            m = self._series.get(key)
            if m is None:
                m = self._series[key] = cls()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {key!r} is a {type(m).__name__}, "
                    f"requested as {cls.__name__}"
                )
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> dict:
        """Everything, rendered to plain JSON-ready dicts."""
        with self._lock:
            items = list(self._series.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, m in items:
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.summary()
        return out

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


#: The process-global default registry every instrumented module records to.
REGISTRY = MetricsRegistry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
