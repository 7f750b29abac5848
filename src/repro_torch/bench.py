"""Benchmark result records and reports: the port of `repro.bench`.

A report is one flat JSON object, the reference's schema:

    {
      "commit":    "<git sha or 'unknown'>",
      "timestamp": "<UTC ISO-8601>",
      "results": [
        {"name": "...", "preset": "...", "metric": "...",
         "value": <number>, "unit": "..."},
        ...
      ]
    }

`validate_report` / `validate_file` are the one definition of that schema
(the same checks and `ValueError` texts as the reference).  Nothing here
picks a file: `write_report` writes where its caller asks.
"""
from __future__ import annotations

import json
import math
import subprocess
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Mapping, Sequence

__all__ = [
    "result_record",
    "make_report",
    "validate_report",
    "validate_file",
    "write_report",
]

_RESULT_FIELDS = {"name": str, "preset": str, "metric": str, "unit": str}


def result_record(name: str, preset: str, metric: str, value: float, unit: str) -> dict:
    """One benchmark observation in the report schema."""
    rec = {"name": name, "preset": preset, "metric": metric, "value": float(value), "unit": unit}
    _validate_result(rec, where=f"result_record({name!r}, {metric!r})")
    return rec


def git_commit(cwd: str | Path | None = None) -> str:
    """The checkout's HEAD at `cwd`, or "unknown" outside a git checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def make_report(results: Sequence[Mapping[str, Any]], *, cwd: str | Path | None = None) -> dict:
    """A validated report of `results`, stamped with `cwd`'s commit and the
    UTC time."""
    report = {
        "commit": git_commit(cwd),
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "results": [dict(r) for r in results],
    }
    validate_report(report)
    return report


def _validate_result(rec: Any, where: str) -> None:
    if not isinstance(rec, Mapping):
        raise ValueError(f"{where}: result entry must be an object, got {type(rec).__name__}")
    for field, typ in _RESULT_FIELDS.items():
        if field not in rec:
            raise ValueError(f"{where}: missing field {field!r}")
        if not isinstance(rec[field], typ):
            raise ValueError(f"{where}: field {field!r} must be {typ.__name__}, got {type(rec[field]).__name__}")
    v = rec.get("value")
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValueError(f"{where}: field 'value' must be a number, got {type(v).__name__}")
    if isinstance(v, float) and not math.isfinite(v):
        raise ValueError(f"{where}: field 'value' must be finite, got {v!r}")
    extra = set(rec) - set(_RESULT_FIELDS) - {"value"}
    if extra:
        raise ValueError(f"{where}: unknown fields {sorted(extra)}")


def validate_report(obj: Any) -> None:
    """Raise ValueError unless `obj` conforms to the report schema."""
    if not isinstance(obj, Mapping):
        raise ValueError(f"report must be an object, got {type(obj).__name__}")
    for field in ("commit", "timestamp"):
        if not isinstance(obj.get(field), str) or not obj.get(field):
            raise ValueError(f"report field {field!r} must be a non-empty string")
    results = obj.get("results")
    if not isinstance(results, list):
        raise ValueError("report field 'results' must be a list")
    if not results:
        raise ValueError("report field 'results' must not be empty")
    for i, rec in enumerate(results):
        _validate_result(rec, where=f"results[{i}]")


def validate_file(path: str | Path, *, expect_commit: str | None = None) -> dict:
    """Load and validate a report file; returns the parsed report.

    `expect_commit` also pins the report's `commit`: a full sha, or "HEAD"
    for the HEAD of the checkout holding the file.  A report written at
    another commit is stale: its numbers do not describe this code."""
    path = Path(path)
    with open(path) as f:
        obj = json.load(f)
    validate_report(obj)
    if expect_commit is not None:
        if expect_commit == "HEAD":
            want = git_commit(path.resolve().parent)
            if want == "unknown":
                raise ValueError(f"{path}: expect_commit='HEAD' but no git commit could be resolved next to the file")
        else:
            want = expect_commit
        if obj["commit"] != want:
            raise ValueError(
                f"{path}: stale trajectory file — report commit {obj['commit'][:12]} != expected {want[:12]}; "
                f"regenerate it at the current checkout with the benchmark that wrote it"
            )
    n = len(obj["results"])
    print(f"[bench] {path}: schema OK ({n} results, commit {obj['commit'][:12]})")
    return obj


def write_report(path: str | Path, results: Sequence[Mapping[str, Any]]) -> dict:
    """Write a report of `results` to `path` (its commit: the checkout
    holding `path`) and return it."""
    report = make_report(results, cwd=Path(path).resolve().parent)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    return report
