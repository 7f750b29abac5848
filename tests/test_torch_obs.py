"""The port's observability layer (repro_torch.obs): the tracer itself, the
spans and events of the engine against the reference's, the always-on
metrics hooks, and the trace join of the PMS predictions.

The contract under test: tracing OFF is free by behaviour (`span()` returns
the shared null object, no device is ever synchronized), tracing ON records
the spans every ported layer promises with the reference's names, counts
and nesting (decompose -> drive -> sweep, plan_build, plan-cache and
autotune-cache events), and a port trace is a reference trace: the JAX
package's `load_jsonl` and `join_trace` read it into the same rows."""
import collections
import json
import math
import warnings

import pytest
import torch

from repro.api import decompose as jax_decompose
from repro.core.remap import plan_blocks as jax_plan_blocks
from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro.obs.calibrate import join_trace as jax_join_trace
from repro_torch.api import decompose
from repro_torch.core import coo as tcoo
from repro_torch.core.loop import finish_iter
from repro_torch.core.memctrl import GPUSpec, MemoryControllerConfig
from repro_torch.core.remap import plan_blocks, plan_blocks_reference
from repro_torch.kernels import ops
from repro_torch.obs import Tracer, metrics, trace
from repro_torch.obs.calibrate import join_trace, predicted_sweep_seconds
from repro_torch.tt import make_planned_tt
from repro_torch.tucker import make_planned_tucker
from repro_torch.tune import cache as tune_cache
from repro_torch.tune.calibrate import DEFAULT_CALIBRATION_CFGS, calibrate

ITERS = 3
# Each format at a rank of the tiny tensor, and its planned workspace.
FORMATS = {"cp": 4, "tucker": (3, 5, 2), "tt": (3, 5)}
BUILDERS = {"cp": ops.make_planned_cp_als, "tucker": make_planned_tucker, "tt": make_planned_tt}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this module's cases.  The suite runs in
    several worker processes on one machine; oversubscribed, torch's
    OpenMP threads spin-wait, and the port's test modules ran 10-100 times
    slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Every test starts and ends with tracing off and fresh registries in
    both packages: their obs state is process-global by design."""
    for t, m in ((trace, metrics), (jax_trace, jax_metrics)):
        t.disable()
        m.reset()
    yield
    for t, m in ((trace, metrics), (jax_trace, jax_metrics)):
        t.disable()
        m.reset()


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


# ---------------------------------------------------------------------------
# the tracer: spans, nesting, export round-trips, enablement
# ---------------------------------------------------------------------------


def test_span_nesting_and_roundtrip(tmp_path):
    tr = Tracer()
    trace.install(tr)
    with trace.span("outer", layer="a"):
        with trace.span("inner", layer="b"):
            trace.event("ping", n=1)
        with trace.span("inner", layer="c"):
            pass
    assert len(tr.spans("outer")) == 1 and len(tr.spans("inner")) == 2
    outer = tr.spans("outer")[0]
    assert outer["parent"] is None
    for rec in tr.spans("inner"):
        assert rec["parent"] == outer["id"] and rec["dur"] >= 0
    (ping,) = tr.events("ping")
    assert ping["args"] == {"n": 1}
    inner_b = [r for r in tr.spans("inner") if r["args"]["layer"] == "b"][0]
    assert ping["parent"] == inner_b["id"]
    assert set(outer) == {"ph", "name", "ts", "dur", "pid", "tid", "id", "parent", "args"}

    path = tmp_path / "t.jsonl"
    assert tr.export_jsonl(path) == 4
    assert trace.load_jsonl(path) == tr.records
    chrome = tmp_path / "t.json"
    assert tr.export_chrome(chrome) == 4
    doc = json.loads(chrome.read_text())
    assert {e["ph"] for e in doc["traceEvents"]} == {"X", "i"}
    assert all("dur" in e and "ts" in e for e in doc["traceEvents"] if e["ph"] == "X")
    tr.clear()
    assert len(tr) == 0


def test_span_set_attaches_mid_span():
    tr = trace.enable()
    with trace.span("s") as sp:
        sp.set(fit=0.5)
    assert tr.spans("s")[0]["args"]["fit"] == 0.5


def test_disabled_calls_are_noops(monkeypatch):
    """Off: span() hands out the shared null object whatever its arguments,
    enters no profiler range and synchronizes no device."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: calls.append(a))
    assert trace.active() is None
    sp = trace.span("x", a=1)
    assert sp is trace.span("y", device="cuda") is trace._NULL_SPAN
    with sp as s:
        s.set(b=2)
    trace.event("never")
    assert calls == []


def test_untraced_decompose_never_synchronizes(monkeypatch, tiny_tensor):
    """A whole decompose with tracing off, and one traced on the CPU: not one
    call to torch.cuda.synchronize."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    pst = to_port(tiny_tensor)
    decompose(pst, 4, iters=2, device="cpu")
    decompose(pst, 4, iters=2, device="cpu", trace=True)
    assert calls == []


def test_span_on_a_cuda_device_synchronizes_before_its_end(monkeypatch):
    """With a CUDA device the span synchronizes that device and sits in an
    NVTX range; on the CPU, or with no device, it does neither."""
    log = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: log.append(("sync", dev)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: log.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: log.append(("pop",)))
    tr = trace.enable()
    with trace.span("plan_build", device="cuda:0", mode=1):
        pass
    assert log == [("push", "plan_build"), ("sync", torch.device("cuda", 0)), ("pop",)]
    assert tr.spans("plan_build")[0]["args"] == {"mode": 1}  # the device is not an attribute
    log.clear()
    with trace.span("host", device="cpu"), trace.span("none"):
        pass
    assert log == []


def test_tracing_scope_restores_previous_tracer(tmp_path):
    outer = trace.enable()
    path = tmp_path / "scoped.jsonl"
    with trace.tracing(str(path)) as tr:
        assert trace.active() is tr
        with trace.span("scoped"):
            pass
    assert trace.active() is outer
    assert [r["name"] for r in trace.load_jsonl(path)] == ["scoped"]
    assert outer.records == []
    mine = Tracer()
    with trace.tracing(mine), trace.span("into_mine"):
        pass
    with trace.tracing(None) as same:
        assert same is outer
    assert [r["name"] for r in mine.records] == ["into_mine"]


def test_load_jsonl_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"ph": "X", "name": "ok", "ts": 1}\nnot json\n')
    with pytest.raises(ValueError, match="not valid JSON"):
        trace.load_jsonl(bad)
    bad.write_text('{"name": "missing ph", "ts": 1}\n')
    with pytest.raises(ValueError, match="missing field"):
        trace.load_jsonl(bad)


def test_configure_from_env(tmp_path, monkeypatch):
    """REPRO_TORCH_TRACE switches the port's tracer; the JAX package's
    REPRO_TRACE does not."""
    monkeypatch.delenv("REPRO_TORCH_TRACE", raising=False)
    monkeypatch.setenv("REPRO_TRACE", "1")
    assert trace.configure_from_env() is None and trace.active() is None
    monkeypatch.setenv("REPRO_TORCH_TRACE", "1")
    tr = trace.configure_from_env()
    assert trace.active() is tr
    trace.disable()
    out = tmp_path / "env.jsonl"
    monkeypatch.setenv("REPRO_TORCH_TRACE", str(out))
    trace.configure_from_env()
    with trace.span("from_env"):
        pass
    trace._export_at_exit()
    assert [r["name"] for r in trace.load_jsonl(out)] == ["from_env"]


def test_metrics_counter_gauge_histogram():
    c = metrics.counter("c", kind="x")
    c.inc()
    c.inc(2)
    assert metrics.counter("c", kind="x") is c
    metrics.gauge("g").set(7.5)
    h = metrics.histogram("h")
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        h.observe(v)
    snap = metrics.snapshot()
    assert snap["counters"]["c{kind=x}"] == 3 and snap["gauges"]["g"] == 7.5
    assert snap["histograms"]["h"]["count"] == 5 and h.percentile(50) == 3.0
    with pytest.raises(TypeError):
        metrics.gauge("c", kind="x")
    metrics.reset()
    assert metrics.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


# ---------------------------------------------------------------------------
# the engine's spans against the reference's
# ---------------------------------------------------------------------------


def shape_of(records) -> collections.Counter:
    """(kind, name, parent's name) of every record: names, counts, nesting."""
    by_id = {r["id"]: r for r in records}
    return collections.Counter(
        (r["ph"], r["name"], by_id[r["parent"]]["name"] if r["parent"] is not None else None)
        for r in records)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_decompose_trace_matches_reference(tiny_tensor, tmp_path, fmt):
    rank = FORMATS[fmt]
    path = tmp_path / f"{fmt}.jsonl"
    out = decompose(to_port(tiny_tensor), rank, format=fmt, iters=ITERS, device="cpu",
                    trace=str(path))
    assert trace.active() is None
    with jax_trace.tracing(True) as ref_tr:
        jax_decompose(tiny_tensor, rank, format=fmt, method="pallas", iters=ITERS)
    recs = trace.load_jsonl(path)
    assert shape_of(recs) == shape_of(ref_tr.records)
    names = [r["name"] for r in recs if r["ph"] == "X"]
    assert (names.count("decompose"), names.count("drive"), names.count("sweep"),
            names.count("plan_build")) == (1, 1, ITERS, tiny_tensor.nmodes)
    by_id = {r["id"]: r for r in recs}
    sweep = next(r for r in recs if r["name"] == "sweep")
    drive = by_id[sweep["parent"]]
    assert drive["name"] == "drive" and by_id[drive["parent"]]["name"] == "decompose"
    (dec,) = [r for r in recs if r["name"] == "decompose"]
    (ref_dec,) = ref_tr.spans("decompose")
    assert dec["args"] == ref_dec["args"]
    assert drive["args"] == ref_tr.spans("drive")[0]["args"]
    # every plan_build carries the reference's attributes
    assert sorted((r["args"]["mode"], r["args"]["builder"], r["args"]["nnz"], r["args"]["blk"])
                  for r in recs if r["name"] == "plan_build") == sorted(
        (r["args"]["mode"], r["args"]["builder"], r["args"]["nnz"], r["args"]["blk"])
        for r in ref_tr.spans("plan_build"))
    assert len(out.fit_history) == ITERS


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_sweep_spans_carry_the_pms_prediction(tiny_tensor, fmt):
    pst = to_port(tiny_tensor)
    with trace.tracing(True) as tr:
        decompose(pst, FORMATS[fmt], format=fmt, iters=2, device="cpu")
    want = predicted_sweep_seconds(BUILDERS[fmt](pst, FORMATS[fmt], device="cpu"))
    assert want > 0
    for sp in tr.spans("sweep"):
        assert sp["args"]["predicted_s"] == pytest.approx(want, rel=1e-6)


def test_untraced_drive_computes_no_prediction(tiny_tensor, monkeypatch):
    ws = ops.make_planned_cp_als(to_port(tiny_tensor), 4, device="cpu")
    monkeypatch.setattr(type(ws), "pms_estimates", lambda *a: pytest.fail("predicted untraced"))
    decompose(to_port(tiny_tensor), 4, iters=2, planned=ws, device="cpu")


def test_drive_metrics(tiny_tensor):
    for fmt, label in (("cp", "cp_als"), ("tucker", "tucker_hooi"), ("tt", "tt_als")):
        decompose(to_port(tiny_tensor), FORMATS[fmt], format=fmt, iters=ITERS, device="cpu")
        snap = metrics.snapshot()
        assert snap["counters"][f"drive.iterations{{label={label}}}"] == ITERS
        assert snap["histograms"][f"drive.iter_seconds{{label={label}}}"]["count"] == ITERS
        assert snap["histograms"][f"drive.fit_delta{{label={label}}}"]["count"] == ITERS - 1


@pytest.mark.parametrize("builder", ["vectorized", "reference"])
def test_plan_build_metrics_match_reference(tiny_tensor, builder):
    """The plan.* series with the reference's definitions and values."""
    build = plan_blocks if builder == "vectorized" else plan_blocks_reference
    for mode in range(tiny_tensor.nmodes):
        build(to_port(tiny_tensor), mode, device="cpu")
        jax_plan_blocks(tiny_tensor, mode)
    snap, ref = metrics.snapshot()["histograms"], jax_metrics.snapshot()["histograms"]
    assert snap[f"plan.build_seconds{{builder={builder}}}"]["count"] == tiny_tensor.nmodes
    for name in ("plan.padding_fraction", "plan.occupancy", "plan.nblocks",
                 "plan.tile_block_imbalance"):
        for stat in ("count", "min", "max", "mean"):
            assert snap[name][stat] == pytest.approx(ref[name][stat], rel=1e-12), (name, stat)
    assert snap["plan.padding_fraction"]["mean"] + snap["plan.occupancy"]["mean"] == pytest.approx(1.0)


def test_plan_cache_counters_events_and_spans(tiny_tensor):
    pst = to_port(tiny_tensor)
    gen = torch.Generator().manual_seed(0)
    facs = [torch.randn((s, 4), generator=gen) for s in pst.shape]
    ops.plan_cache_clear()
    tr = trace.enable()
    try:
        ops.mttkrp_auto(pst, facs, 0, device="cpu")  # miss
        ops.mttkrp_auto(pst, facs, 0, device="cpu")  # hit
        ops.mttkrp_auto(pst, facs, 1, device="cpu")  # miss
    finally:
        trace.disable()
        stats = ops.plan_cache_stats()["by_kind"]["mttkrp"]
        ops.plan_cache_clear()
    snap = metrics.snapshot()
    assert snap["counters"]["plan_cache.misses{kind=mttkrp}"] == stats["misses"] == 2
    assert snap["counters"]["plan_cache.hits{kind=mttkrp}"] == stats["hits"] == 1
    (hit,) = tr.events("plan_cache_hit")
    assert hit["args"] == {"kind": "mttkrp", "mode": 0}
    builds = tr.spans("plan_cache_build")
    assert [b["args"]["mode"] for b in builds] == [0, 1]
    # each cache build holds its plan's build
    assert all(tr.spans("plan_build")[k]["parent"] == builds[k]["id"] for k in range(2))


def test_plan_cache_eviction_event(tiny_tensor):
    pst = to_port(tiny_tensor)
    facs = [torch.ones((s, 4)) for s in pst.shape]
    old_cap = ops.plan_cache_config()
    ops.plan_cache_clear()
    tr = trace.enable()
    try:
        ops.plan_cache_config(1)
        ops.mttkrp_auto(pst, facs, 0, device="cpu")
        ops.mttkrp_auto(pst, facs, 1, device="cpu")  # evicts mode 0's plan
        ops.mttkrp_auto(pst, facs, 0, device="cpu")  # evicts mode 1's
    finally:
        trace.disable()
        ops.plan_cache_config(old_cap)
        ops.plan_cache_clear()
    assert [e["args"] for e in tr.events("plan_cache_evict")] == [
        {"kind": "mttkrp", "mode": 0}, {"kind": "mttkrp", "mode": 1}]
    assert metrics.snapshot()["counters"]["plan_cache.evictions"] == 2


def test_nonfinite_fit_event_and_counter():
    tr = trace.enable()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        stop = finish_iter([], float("nan"), 3, None, False, "unit")
    assert stop is True
    assert metrics.snapshot()["counters"]["resilience.nonfinite_fit{label=unit}"] == 1
    (ev,) = tr.events("nonfinite_fit")
    assert ev["args"] == {"label": "unit", "it": 3, "fit": "nan"}


def test_autotune_cache_events(tmp_path):
    cache = tune_cache.AutotuneCache(tmp_path / "autotune_torch.json")
    tr = trace.enable()
    cache.put_spec("cpu", GPUSpec())
    cfg = MemoryControllerConfig()
    for _ in range(2):  # a search and a store, then a hit
        assert tune_cache.cached_config("mttkrp", "f" * 12, 2, 8, GPUSpec(), lambda: cfg,
                                        cache=cache) == cfg
    assert [e["args"] for e in tr.events("autotune_spec_store")] == [{"backend": "cpu"}]
    assert [s["args"] for s in tr.spans("autotune_cache_search")] == [{"kind": "mttkrp", "mode": 2}]
    assert [e["args"] for e in tr.events("autotune_cache_hit")] == [{"kind": "mttkrp", "mode": 2}]


def test_calibrate_is_one_span():
    with trace.tracing(True) as tr:
        calibrate("tiny", rank=4, cfgs=DEFAULT_CALIBRATION_CFGS[:2], reps=1, microbench=False,
                  device="cpu")
    (sp,) = tr.spans("tune_calibrate")
    assert sp["args"] == {"backend": "cpu", "preset": "tiny"}


# ---------------------------------------------------------------------------
# the trace join: a port trace reads as a reference trace
# ---------------------------------------------------------------------------


def test_port_trace_joins_in_both_packages(tiny_tensor, tmp_path):
    path = tmp_path / "all.jsonl"
    pst = to_port(tiny_tensor)
    with trace.tracing(str(path)):
        for fmt, rank in FORMATS.items():
            decompose(pst, rank, format=fmt, iters=ITERS, device="cpu")
    rows = join_trace(path)
    assert rows == jax_join_trace(str(path))
    assert rows == join_trace(jax_trace.load_jsonl(path))
    assert [r["label"] for r in rows] == ["cp_als", "tt_als", "tucker_hooi"]
    for r in rows:
        assert r["n_sweeps"] == ITERS and r["measured_s"] > 0
        assert math.isfinite(r["achieved_pct"]) and r["achieved_pct"] > 0


def test_join_trace_on_fixed_fixture():
    """1 first sweep + 3 steady ones: measured = the median of the steady
    three, achieved = predicted / measured."""
    recs = [{"ph": "X", "name": "sweep", "ts": i * 100.0, "dur": dur,
             "args": {"label": "cp_als", "predicted_s": 0.002}}
            for i, dur in enumerate((9000.0, 4000.0, 5000.0, 6000.0))]
    recs.append({"ph": "X", "name": "sweep", "ts": 0.0, "dur": 10.0, "args": {"label": "bare"}})
    (bare, cp) = join_trace(recs)
    assert cp["n_sweeps"] == 4 and cp["measured_s"] == pytest.approx(0.005)
    assert cp["achieved_pct"] == pytest.approx(40.0)
    assert bare["predicted_s"] is None and bare["achieved_pct"] is None
    assert join_trace(recs) == jax_join_trace(recs)
