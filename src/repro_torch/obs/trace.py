"""Span/event tracer for the planned decomposition engine.

Counterpart of `repro.obs.trace`, with the same surface and the same JSONL
records.  The hot paths call `span("sweep", ...)` / `event("guard", ...)`
unconditionally; when no tracer is installed those calls are one
module-global read and the return of a shared no-op context manager, so a
disabled call allocates nothing, enters no profiler range and never
synchronizes a device.

Enable switches (process-global):

  * ``REPRO_TORCH_TRACE=1``: collect spans in a process-global `Tracer`
    (read at import; `configure_from_env()` re-reads it).  Any other
    non-empty value is a JSONL path the collected trace is exported to at
    interpreter exit.  (Not ``REPRO_TRACE``: that is the JAX package's
    switch, and the two packages may share a process.)
  * ``enable(path=None)`` / ``disable()``: the programmatic switch.
  * ``tracing(target)``: scoped enablement; `decompose(st, r, trace=...)`
    wraps the whole call in it (`target` may be True, a path, or a Tracer).

Device time.  Work on the card is asynchronous: a span that closes when
its launches are queued measures the launch.  A span opened with a CUDA
`device=` synchronizes that device before it takes its end time; only
while a tracer is active, and never for a CPU device.  Spans whose body
ends in a host transfer (the `sweep` span encloses the fit's `float()`)
need no device.

Every active span also enters `torch.profiler.record_function(name)`, so
spans show up in `torch.profiler` traces beside the kernels they launch,
and a span with a CUDA device an NVTX range of the same name.

Export formats: JSONL (one span/event object per line: ph, name, ts and
dur in microseconds since the tracer's epoch, pid, tid, id, parent, args;
what `obs.calibrate.join_trace` reads) and Chrome trace-event JSON
(``chrome://tracing`` / ``ui.perfetto.dev``).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from pathlib import Path

import torch

__all__ = [
    "Tracer",
    "span",
    "event",
    "active",
    "enable",
    "disable",
    "install",
    "load_jsonl",
    "tracing",
    "configure_from_env",
]

ENV_VAR = "REPRO_TORCH_TRACE"
_PID = os.getpid()


def _cuda_device(device) -> torch.device | None:
    """`device` as a torch.device when it names a CUDA device, else None
    (None, "cpu", a CPU torch.device)."""
    if device is None:
        return None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


class _NullSpan:
    """The shared disabled-path context manager: no state, no allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):  # same surface as _Span
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records (name, ts, dur, thread, parent, attrs) into its
    tracer on exit.  Nesting is tracked per thread via the tracer's
    thread-local span stack, so concurrent drives trace independently."""

    __slots__ = ("_tracer", "name", "attrs", "_device", "_t0", "id", "parent", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict, device: torch.device | None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._device = device

    def set(self, **attrs):
        """Attach attributes mid-span (e.g. a fit computed inside it)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        self.id = tr._next_id()
        stack.append(self.id)
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        if self._device is not None:
            torch.cuda.nvtx.range_push(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._device is not None:
            torch.cuda.synchronize(self._device)
        dur = time.perf_counter_ns() - self._t0
        if self._device is not None:
            torch.cuda.nvtx.range_pop()
        self._ann.__exit__(*exc)
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        tr._record({
            "ph": "X",
            "name": self.name,
            "ts": (self._t0 - tr._epoch) / 1e3,  # µs since tracer epoch
            "dur": dur / 1e3,
            "pid": _PID,
            "tid": threading.get_ident(),
            "id": self.id,
            "parent": self.parent,
            "args": self.attrs,
        })
        return False


class Tracer:
    """Thread-safe span/event collector.

    Spans are recorded at exit (duration events, ``ph="X"``), instantaneous
    events at emission (``ph="i"``); both carry microsecond timestamps
    relative to the tracer's construction epoch, the recording thread id,
    and a per-tracer span id / parent id for nesting round-trips."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._epoch = time.perf_counter_ns()
        self._counter = 0
        self.records: list[dict] = []

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._counter += 1
            return self._counter

    def _record(self, rec: dict) -> None:
        with self._lock:
            self.records.append(rec)

    def span(self, name: str, device=None, **attrs) -> _Span:
        """A span; with a CUDA `device`, synchronized before its end time."""
        return _Span(self, name, attrs, _cuda_device(device))

    def event(self, name: str, **attrs) -> None:
        self._record({
            "ph": "i",
            "name": name,
            "ts": (time.perf_counter_ns() - self._epoch) / 1e3,
            "pid": _PID,
            "tid": threading.get_ident(),
            "id": self._next_id(),
            "parent": (self._stack() or [None])[-1],
            "args": attrs,
        })

    # -- inspection / export ----------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self.records)

    def spans(self, name: str | None = None) -> list[dict]:
        with self._lock:
            recs = list(self.records)
        return [r for r in recs if r["ph"] == "X" and (name is None or r["name"] == name)]

    def events(self, name: str | None = None) -> list[dict]:
        with self._lock:
            recs = list(self.records)
        return [r for r in recs if r["ph"] == "i" and (name is None or r["name"] == name)]

    def clear(self) -> None:
        with self._lock:
            self.records.clear()

    def export_jsonl(self, path: str | Path) -> int:
        """One record per line; returns the record count written."""
        with self._lock:
            recs = list(self.records)
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        return len(recs)

    def export_chrome(self, path: str | Path) -> int:
        """Chrome trace-event JSON (chrome://tracing, ui.perfetto.dev)."""
        with self._lock:
            recs = list(self.records)
        events = []
        for r in recs:
            e = {"name": r["name"], "ph": r["ph"], "ts": r["ts"],
                 "pid": r["pid"], "tid": r["tid"], "args": dict(r["args"])}
            if r["ph"] == "X":
                e["dur"] = r["dur"]
            else:
                e["s"] = "t"  # thread-scoped instant
            events.append(e)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
            f.write("\n")
        return len(events)


def load_jsonl(path: str | Path) -> list[dict]:
    """Parse a trace JSONL back into records (the export round-trip)."""
    recs = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: not valid JSON ({e})") from e
            for field in ("ph", "name", "ts"):
                if field not in rec:
                    raise ValueError(f"{path}:{ln}: missing field {field!r}")
            recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# Process-global enablement
# ---------------------------------------------------------------------------

_ACTIVE: Tracer | None = None
_EXIT_PATH: Path | None = None


def active() -> Tracer | None:
    """The installed tracer, or None when tracing is off."""
    return _ACTIVE


def span(name: str, device=None, **attrs):
    """A span against the active tracer (synchronized on a CUDA `device`
    before its end); the shared no-op when tracing is off (one global read
    and one return)."""
    t = _ACTIVE
    if t is None:
        return _NULL_SPAN
    return t.span(name, device, **attrs)


def event(name: str, **attrs) -> None:
    """An instantaneous event against the active tracer; no-op when off."""
    t = _ACTIVE
    if t is not None:
        t.event(name, **attrs)


def install(tracer: Tracer | None) -> Tracer | None:
    """Install (or with None, remove) the process-global tracer; returns the
    previously installed one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    return prev


def enable(path: str | Path | None = None) -> Tracer:
    """Install a fresh process-global tracer; with `path`, also export the
    collected JSONL there at interpreter exit."""
    global _EXIT_PATH
    tr = Tracer()
    install(tr)
    if path is not None:
        _EXIT_PATH = Path(path)
    return tr


def disable() -> None:
    global _EXIT_PATH
    install(None)
    _EXIT_PATH = None


@atexit.register
def _export_at_exit() -> None:
    if _ACTIVE is not None and _EXIT_PATH is not None:
        try:
            _ACTIVE.export_jsonl(_EXIT_PATH)
        except OSError:
            pass


class tracing:
    """Scoped tracing for one call tree: the `decompose(..., trace=...)`
    switch.  `target` may be:

      * None / False: no-op (whatever tracer is active stays active);
      * True: install a fresh Tracer for the scope;
      * str / Path: a fresh Tracer, exported as JSONL to that path on exit;
      * a Tracer: install the caller's collector for the scope.

    The previously active tracer is restored on exit, so scoped traces nest
    under (and temporarily shadow) the REPRO_TORCH_TRACE global tracer."""

    def __init__(self, target=None):
        self.target = target
        self.tracer: Tracer | None = None
        self._path: Path | None = None
        self._prev: Tracer | None = None
        self._installed = False

    def __enter__(self):
        t = self.target
        if t is None or t is False:
            self.tracer = _ACTIVE
            return self.tracer
        if isinstance(t, Tracer):
            self.tracer = t
        else:
            self.tracer = Tracer()
            if t is not True:
                self._path = Path(t)
        self._prev = install(self.tracer)
        self._installed = True
        return self.tracer

    def __exit__(self, *exc):
        if self._installed:
            install(self._prev)
            if self._path is not None:
                self.tracer.export_jsonl(self._path)
        return False


def configure_from_env() -> Tracer | None:
    """Apply the ``REPRO_TORCH_TRACE`` switch: truthy values ("1"/"true"/
    "yes"/"on") enable collection; any other non-empty value enables
    collection AND exports JSONL to that path at exit; empty/unset leaves
    tracing off.  Called once at import; call again after changing the
    environment."""
    raw = os.environ.get(ENV_VAR, "").strip()
    if not raw:
        return None
    if raw.lower() in ("1", "true", "yes", "on"):
        return enable()
    return enable(raw)


configure_from_env()
