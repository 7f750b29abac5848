"""Trace-report CLI of the PyTorch port: summarize a repro_torch.obs trace
JSONL on the terminal.

  PYTHONPATH=src python scripts/torch_trace_report.py TRACE.jsonl [options]

The trace is what `REPRO_TORCH_TRACE=PATH` or `decompose(..., trace=PATH)`
wrote.  The default output is a table per span name (count, total, mean and
max duration) and the counts of the instant events: where a decompose()
spent its time.  Options:

  --pms           achieved-vs-predicted table from the trace's "sweep" spans
                  (repro_torch.obs.calibrate.join_trace; the spans carry
                  `predicted_s` where the workspace has a PMS hook)
  --chrome PATH   convert the JSONL to Chrome trace-event JSON (open in
                  chrome://tracing or https://ui.perfetto.dev)
  --by-mode       break span rows out by their `mode` arg (plan_build and
                  plan_cache_build spans carry one)
  --device DEV    as every entry point of the port: CUDA unless given, and
                  raises without a GPU; the report itself only reads the file

The loader validates every line (repro_torch.obs.trace.load_jsonl); a
malformed file exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def _span_key(rec: dict, by_mode: bool) -> str:
    name = rec["name"]
    if by_mode and "mode" in rec.get("args", {}):
        return f"{name}[mode={rec['args']['mode']}]"
    return name


def summarize(records: list[dict], by_mode: bool = False) -> str:
    """The span table (longest total first) and the event counts."""
    spans: dict[str, list[float]] = defaultdict(list)
    events: dict[str, int] = defaultdict(int)
    for r in records:
        if r.get("ph") == "X":
            spans[_span_key(r, by_mode)].append(float(r.get("dur", 0.0)))
        elif r.get("ph") == "i":
            events[r["name"]] += 1
    lines = []
    if spans:
        header = f"{'span':<28} {'count':>6} {'total_s':>10} {'mean_s':>10} {'max_s':>10}"
        lines += [header, "-" * len(header)]
        for name, durs in sorted(spans.items(), key=lambda kv: -sum(kv[1])):
            tot = sum(durs) / 1e6
            lines.append(f"{name:<28} {len(durs):>6d} {tot:>10.4f} {tot / len(durs):>10.4f} {max(durs) / 1e6:>10.4f}")
    if events:
        lines.append("")
        header = f"{'event':<28} {'count':>6}"
        lines += [header, "-" * len(header)]
        for name, n in sorted(events.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<28} {n:>6d}")
    return "\n".join(lines) if lines else "(empty trace)"


def to_chrome(records: list[dict], path: str | Path) -> None:
    """Chrome trace-event JSON: the records already use the trace-event
    field names (ph/name/ts/dur/pid/tid/args), so they are wrapped in the
    envelope, without the JSONL's id/parent links."""
    events = [{k: v for k, v in r.items() if k not in ("id", "parent")} for r in records]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        f.write("\n")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="trace JSONL (REPRO_TORCH_TRACE=path / decompose(trace=path) output)")
    ap.add_argument("--pms", action="store_true", help="achieved-vs-predicted PMS table from sweep spans")
    ap.add_argument("--chrome", metavar="PATH", default=None, help="write Chrome trace-event JSON to PATH")
    ap.add_argument("--by-mode", action="store_true", help="break spans out by their `mode` arg")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA; 'cpu' to run there)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.obs.calibrate import format_table, join_trace
    from repro_torch.obs.trace import load_jsonl

    resolve_device(a.device)
    try:
        records = load_jsonl(a.trace)
    except (OSError, ValueError) as e:
        print(f"torch_trace_report: invalid trace {a.trace}: {e}", file=sys.stderr)
        return 1
    if not records:
        print(f"torch_trace_report: {a.trace} holds no records", file=sys.stderr)
        return 1
    print(f"# {a.trace}: {len(records)} records")
    print(summarize(records, by_mode=a.by_mode))
    if a.pms:
        rows = join_trace(records)
        print()
        print(format_table(rows) if rows else "(no sweep spans to join)")
    if a.chrome:
        to_chrome(records, a.chrome)
        print(f"\nchrome trace -> {a.chrome}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
