"""`repro_torch.bench` and `repro_torch.obs.calibrate.accuracy_records`
against the JAX package's: the same records, reports and `ValueError`
texts for the same inputs, and a `validate_file` round trip under
tmp_path."""
import json
import math
import subprocess

import pytest
from torch_threads import one_torch_thread  # noqa: F401

from repro import bench as rbench
from repro.obs import calibrate as rcal
from repro_torch import bench as tbench
from repro_torch.obs import calibrate as tcal

GOOD = [("mttkrp", "tiny", "sweep_ms", 1.25, "ms"), ("cp", "nell2_like", "fit", 0.5, ""),
        ("plan", "4d_small", "blocks", 7, "count")]


def _error(fn, *args, **kwargs) -> str | None:
    try:
        fn(*args, **kwargs)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("rec", GOOD)
def test_result_record_matches_reference(rec):
    assert tbench.result_record(*rec) == rbench.result_record(*rec)


BAD_RECORDS = [
    ("mttkrp", "tiny", "sweep_ms", float("nan"), "ms"),
    ("mttkrp", "tiny", "sweep_ms", math.inf, "ms"),
    ("mttkrp", "tiny", "sweep_ms", "fast", "ms"),
    (1, "tiny", "sweep_ms", 1.0, "ms"),
    ("mttkrp", "tiny", "sweep_ms", 1.0, None),
]


@pytest.mark.parametrize("rec", BAD_RECORDS, ids=range(len(BAD_RECORDS)))
def test_result_record_errors_match_reference(rec):
    want = _error(rbench.result_record, *rec)
    assert want is not None and _error(tbench.result_record, *rec) == want


def _report():
    return {"commit": "abc", "timestamp": "2026-01-01T00:00:00+00:00",
            "results": [rbench.result_record(*r) for r in GOOD]}


def _with(**changes):
    rep = _report()
    rep.update(changes)
    return rep


BAD_REPORTS = [
    [],
    _with(commit=""),
    _with(timestamp=3),
    _with(results={}),
    _with(results=[]),
    _with(results=[{"name": "a", "preset": "p", "metric": "m", "value": True, "unit": "u"}]),
    _with(results=[{"name": "a", "preset": "p", "metric": "m", "value": 1.0, "unit": "u", "extra": 1}]),
    _with(results=[{"name": "a", "preset": "p", "value": 1.0, "unit": "u"}]),
    _with(results=["record"]),
]


@pytest.mark.parametrize("rep", BAD_REPORTS, ids=range(len(BAD_REPORTS)))
def test_validate_report_errors_match_reference(rep):
    want = _error(rbench.validate_report, rep)
    assert want is not None and _error(tbench.validate_report, rep) == want


def test_make_report_matches_reference(tmp_path):
    results = [rbench.result_record(*r) for r in GOOD]
    want, got = rbench.make_report(results, cwd=tmp_path), tbench.make_report(results, cwd=tmp_path)
    assert got["commit"] == want["commit"] == "unknown"  # tmp_path is no git checkout
    assert got["results"] == want["results"]
    assert set(got) == set(want) == {"commit", "timestamp", "results"}
    tbench.validate_report(got)
    assert _error(tbench.make_report, []) == _error(rbench.make_report, [])


def _git_checkout(path):
    def git(*args):
        subprocess.run(["git", *args], cwd=path, check=True, capture_output=True, timeout=30)

    git("init", "-q")
    git("-c", "user.name=t", "-c", "user.email=t@t", "commit", "-q", "--allow-empty", "-m", "c")
    return subprocess.run(["git", "rev-parse", "HEAD"], cwd=path, check=True, capture_output=True, text=True,
                          timeout=30).stdout.strip()


def test_validate_file_round_trip(tmp_path, capsys):
    results = [tbench.result_record(*r) for r in GOOD]
    outside = tmp_path / "outside" / "report.json"
    outside.parent.mkdir()
    written = tbench.write_report(outside, results)
    assert json.loads(outside.read_text()) == written
    assert tbench.validate_file(outside) == written == rbench.validate_file(outside)
    assert "schema OK (3 results, commit unknown)" in capsys.readouterr().out
    # No checkout next to the file: "HEAD" cannot resolve, in both packages.
    assert _error(tbench.validate_file, outside, expect_commit="HEAD") \
        == _error(rbench.validate_file, outside, expect_commit="HEAD")

    repo = tmp_path / "repo"
    repo.mkdir()
    head = _git_checkout(repo)
    fresh = repo / "report.json"
    tbench.write_report(fresh, results)
    assert tbench.validate_file(fresh, expect_commit="HEAD")["commit"] == head
    assert tbench.validate_file(fresh, expect_commit=head)["commit"] == head
    stale = _error(tbench.validate_file, fresh, expect_commit="0" * 40)
    assert stale.startswith(f"{fresh}: stale trajectory file — report commit {head[:12]} != expected 000000000000")
    assert "bench_e2e" not in stale and "benchmarks/" not in stale
    ref_stale = _error(rbench.validate_file, fresh, expect_commit="0" * 40)
    assert stale.split(";")[0] == ref_stale.split(";")[0]

    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps(_with(results=[])))
    assert _error(tbench.validate_file, broken) == _error(rbench.validate_file, broken)


ROWS = [("cp", "tiny", 2.5e-4, 1.0e-3), ("tucker", "nell2_like", 3.0e-2, 4.5e-2), ("tt", "4d_small", 1.0, 0.25)]


def test_accuracy_records_match_reference():
    want = rcal.accuracy_records([rcal.CalibrationRow(*r) for r in ROWS])
    got = tcal.accuracy_records([tcal.CalibrationRow(*r) for r in ROWS])
    assert got == want and len(got) == 3 * len(ROWS)
    tbench.validate_report({"commit": "c", "timestamp": "t", "results": got})
