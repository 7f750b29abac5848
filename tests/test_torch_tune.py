"""`repro_torch.tune` (the measured-roofline fit and the persistent autotune
cache), `repro_torch.obs.calibrate`, and `auto_tune=` on the port's
planned paths, against the reference where the two must agree:

  * `fit_spec` gives the reference's solution on the same samples, its
    fallbacks included, and recovers known constants;
  * the cache keeps its robustness contract in a file of its own, never
    the JAX package's `autotune.json`, under keys shaped like the
    reference's;
  * a warm `auto_tune="cached"` decompose evaluates no configuration;
  * `decompose(auto_tune=True)` gives the fits of `decompose(cfg=<the
    chosen config>)` and of the reference's `decompose(cfg=<the same
    config>, method="pallas")` from the same initial factors.
"""
import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.api import decompose as jax_decompose
from repro.core.coo import random_factors
from repro.core.memctrl import CacheEngineConfig as JCache
from repro.core.memctrl import DMAEngineConfig as JDMA
from repro.core.memctrl import MemoryControllerConfig as JConfig
from repro.core.memctrl import TPUSpec
from repro.core.memctrl import config_to_dict as jconfig_to_dict
from repro.tt import init_tt_cores as jax_init_tt_cores
from repro.tucker import init_tucker_factors as jax_init_tucker_factors
from repro.tune import CalibSample as JCalibSample
from repro.tune import cache_path as jcache_path
from repro.tune import config_key as jconfig_key
from repro.tune import fit_spec as jfit_spec
from repro.tune import predicted_seconds as jpredicted_seconds
from repro_torch.api import decompose
from repro_torch.convert import config_from_reference, factors_from_numpy
from repro_torch.core import coo as tcoo
from repro_torch.core.memctrl import (
    CacheEngineConfig,
    DMAEngineConfig,
    GPUSpec,
    MemoryControllerConfig,
    config_from_dict,
    config_to_dict,
    spec_from_dict,
    spec_to_dict,
)
from repro_torch.kernels.ops import make_planned_cp_als
from repro_torch.obs import calibrate as ocal
from repro_torch.obs import metrics
from repro_torch.tt import make_planned_tt
from repro_torch.tucker import make_planned_tucker
from repro_torch.tune import (
    SCHEMA_VERSION,
    AutotuneCache,
    CalibSample,
    cache_path,
    cached_config,
    calibrate_and_store,
    config_key,
    current_backend,
    fit_spec,
    l2_bytes,
    measure_hbm_bw,
    measure_peak_flops_f32,
    predicted_seconds,
    resolve_spec,
    roofline_counts,
    sweep_sample,
)

FIT_TOL = 1e-5  # the ROADMAP's fit bar
ITERS = 3
CFG_SMALL = MemoryControllerConfig(cache=CacheEngineConfig(tile_i=32, tile_j=16, tile_k=64),
                                   dma=DMAEngineConfig(blk=64))


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test gets its own on-disk cache and a clean metrics registry."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path / "autotune"))
    metrics.reset()
    yield
    metrics.reset()


def counters() -> dict:
    return metrics.snapshot()["counters"]


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


# --- fit_spec -----------------------------------------------------------------

# (bytes, flops, seconds) per sample: a well-posed system; one whose flop
# coefficient comes out negative; one whose byte coefficient does;
# collinear samples (flops a fixed multiple of bytes); and flops the same
# at every sample, as the port's CP sweep gives them (its kernel's flops do
# not depend on the geometry), where the flop term takes the intercept.
FIT_CASES = {
    "well_posed": [(1e9, 1e10, 1e9 / 3e12 + 1e10 / 6e13), (5e9, 1e10, 5e9 / 3e12 + 1e10 / 6e13),
                   (1e9, 8e10, 1e9 / 3e12 + 8e10 / 6e13)],
    "flops_fallback": [(1e9, 1e9, 2e-3), (2e9, 1.5e9, 3.9e-3), (3e9, 3e9, 5.8e-3)],
    "bytes_fallback": [(1e9, 1e9, 2e-3), (1.5e9, 2e9, 3.9e-3), (3e9, 3e9, 5.8e-3)],
    "collinear": [(1e9, 3e9, 1e-3), (2e9, 6e9, 2.1e-3), (4e9, 12e9, 3.9e-3)],
    "constant_flops": [(1e9, 5e9, 2e-3), (2e9, 5e9, 2.5e-3), (4e9, 5e9, 3.6e-3)],
}


def samples(case):
    rows = FIT_CASES[case]
    port = [CalibSample(f"s{i}", ((b, f),), t) for i, (b, f, t) in enumerate(rows)]
    ref = [JCalibSample(f"s{i}", ((b, f),), t) for i, (b, f, t) in enumerate(rows)]
    return port, ref


@pytest.mark.parametrize("fallbacks", [(None, None), (2.9e12, 5.5e13)])
@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_spec_matches_reference(case, fallbacks):
    """The same least-squares solution and the same fallback branches; the
    default bases differ (H100 vs TPU data sheets), so each side's fallback
    without a microbenchmark is its own base's constant."""
    port, ref = samples(case)
    bw, pf = fallbacks
    base = GPUSpec(hbm_bw=TPUSpec().hbm_bw, peak_flops_f32=TPUSpec().peak_flops_f32,
                   peak_flops=TPUSpec().peak_flops)
    got = fit_spec(port, base, fallback_hbm_bw=bw, fallback_peak_flops=pf)
    want = jfit_spec(ref, TPUSpec(), fallback_hbm_bw=bw, fallback_peak_flops=pf)
    assert (got.hbm_bw, got.peak_flops_f32, got.peak_flops) == (
        want.hbm_bw, want.peak_flops_f32, want.peak_flops)
    for s, r in zip(port, ref):
        assert predicted_seconds(s.per_mode, got) == jpredicted_seconds(r.per_mode, want)


def test_fit_spec_fallbacks_fire_and_recover_known_constants():
    bw, pf = 3.0e12, 6.0e13
    rows = [(b, f, b / bw + f / pf) for b, f in ((1e9, 1e10), (5e9, 1e10), (1e9, 8e10))]
    fitted = fit_spec([CalibSample("x", ((b, f),), t) for b, f, t in rows])
    assert fitted.hbm_bw == pytest.approx(bw, rel=1e-9)
    assert fitted.peak_flops_f32 == pytest.approx(pf, rel=1e-9)
    assert fitted.peak_flops / fitted.peak_flops_f32 == pytest.approx(
        GPUSpec().peak_flops / GPUSpec().peak_flops_f32)
    port, _ = samples("flops_fallback")
    assert fit_spec(port, fallback_peak_flops=5.5e13).peak_flops_f32 == 5.5e13
    port, _ = samples("bytes_fallback")
    assert fit_spec(port).hbm_bw == GPUSpec().hbm_bw
    with pytest.raises(ValueError, match="at least one"):
        fit_spec([])
    for fit, sample in ((fit_spec, CalibSample), (jfit_spec, JCalibSample)):
        with pytest.raises(ValueError, match="measured_s > 0"):
            fit([sample("x", ((1e9, 1e9),), 1e-3), sample("y", ((2e9, 1e9),), 0.0)])


# --- the cache ----------------------------------------------------------------


def test_spec_and_config_round_trip_bit_for_bit():
    spec = dataclasses.replace(GPUSpec(), hbm_bw=2.71828e12, peak_flops_f32=5.4321e13)
    assert spec_from_dict(json.loads(json.dumps(spec_to_dict(spec)))) == spec
    for cfg in (MemoryControllerConfig(), CFG_SMALL):
        assert config_from_dict(json.loads(json.dumps(config_to_dict(cfg)))) == cfg
    with pytest.raises(ValueError, match="unknown fields"):
        config_from_dict({"cache": {"tile_i": 8, "resident_tiles": 1}})


def test_reference_config_payload_converts():
    """The reference's `config_to_dict` payload names the same geometry in
    the port; the fields only its VMEM model reads are dropped."""
    ref = JConfig(cache=JCache(tile_i=32, tile_j=16, tile_k=64), dma=JDMA(blk=64))
    assert config_from_reference(jconfig_to_dict(ref)) == CFG_SMALL
    assert config_from_reference(jconfig_to_dict(JConfig())) == MemoryControllerConfig()
    with pytest.raises(ValueError, match="unknown fields"):
        config_from_reference({"cache": {"tile_x": 1}})


def test_cache_round_trip_on_disk_in_its_own_file(tmp_path, monkeypatch):
    cache = AutotuneCache()
    spec = dataclasses.replace(GPUSpec(), hbm_bw=2.5e12)
    cache.put_spec("cuda:test", spec, note="test")
    assert cache.get_spec("cuda:test") == spec
    key = config_key("mttkrp", "f" * 12, 0, 8, backend="cpu", spec=spec)
    cache.put_config(key, CFG_SMALL)
    assert AutotuneCache().get_spec("cuda:test") == spec
    assert AutotuneCache().get_config(key) == CFG_SMALL
    # Both packages pointed at one directory: two files, and the reference's
    # stays untouched.
    monkeypatch.setenv("REPRO_AUTOTUNE_DIR", str(cache_path().parent))
    assert jcache_path().parent == cache_path().parent
    assert jcache_path() != cache_path() and cache_path().name == "autotune_torch.json"
    assert not jcache_path().exists()
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_DIR")
    assert "repro-torch-autotune" in str(cache_path())


def test_config_key_has_the_reference_shape():
    """Same fields in the same order; only the spec fingerprint (another
    spec type) differs."""
    spec = GPUSpec()
    for nshards in (None, 4):
        got = config_key("tt", "a" * 40, 2, (3, 5), backend="cpu", spec=spec, nshards=nshards)
        want = jconfig_key("tt", "a" * 40, 2, (3, 5), backend="cpu", spec=TPUSpec(),
                           nshards=nshards)
        g, w = got.split("|"), want.split("|")
        assert len(g) == len(w) == 8
        assert [x for i, x in enumerate(g) if i != 6] == [x for i, x in enumerate(w) if i != 6]
        assert g[6].startswith("spec=") and g[6] != w[6]
    assert current_backend() == ("cpu" if not torch.cuda.is_available()
                                 else f"cuda:{torch.cuda.get_device_name()}")


@pytest.mark.parametrize("payload", [
    "",
    "{not json",
    '{"schema_version": 1, "specs": {}, "configs"',
    '"a bare string"',
    '{"schema_version": 9999, "specs": {}, "configs": {}}',
    '{"schema_version": 1, "specs": [], "configs": {}}',
])
def test_corrupt_cache_degrades_to_clean_miss(payload):
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(payload)
    cache = AutotuneCache()
    assert cache.get_spec("cpu") is None
    key = config_key("mttkrp", "a" * 12, 0, 8, backend=current_backend(), spec=GPUSpec())
    assert cache.get_config(key) is None
    ran = []
    cfg = cached_config("mttkrp", "a" * 12, 0, 8, GPUSpec(),
                        lambda: ran.append(1) or MemoryControllerConfig())
    assert ran == [1] and cfg == MemoryControllerConfig()
    assert json.loads(path.read_text())["schema_version"] == SCHEMA_VERSION
    assert cache.get_config(key) == MemoryControllerConfig()


def test_unknown_entry_fields_read_as_miss():
    cache = AutotuneCache()
    cache.put_spec("cpu", GPUSpec())
    data = cache.load()
    data["specs"]["cpu"]["spec"]["vmem_bytes"] = 1  # a TPU field: not the port's spec
    key = config_key("mttkrp", "b" * 12, 0, 8, backend="cpu", spec=GPUSpec())
    data["configs"][key] = {"cfg": {"cache": {}, "dma": {"buffers": 2}, "remapper": {}}}
    cache._write(data)
    assert cache.get_spec("cpu") is None
    assert cache.get_config(key) is None


def test_keys_never_collide():
    fp, spec = "c" * 12, GPUSpec()
    keys = [config_key("mttkrp", fp, 0, 8, backend="cpu", spec=spec),
            config_key("ttmc", fp, 0, 8, backend="cpu", spec=spec),
            config_key("tt", fp, 0, 8, backend="cpu", spec=spec),
            config_key("mttkrp", fp, 0, 8, backend="cuda:NVIDIA H100 80GB HBM3", spec=spec),
            config_key("mttkrp", fp, 1, 8, backend="cpu", spec=spec),
            config_key("mttkrp", fp, 0, (8, 8, 8), backend="cpu", spec=spec),
            config_key("mttkrp", fp, 0, 8, backend="cpu", spec=dataclasses.replace(spec, hbm_bw=1e9)),
            config_key("mttkrp", "d" * 12, 0, 8, backend="cpu", spec=spec)]
    assert len(set(keys)) == len(keys)


def test_concurrent_writers_keep_file_valid():
    cache, errors = AutotuneCache(), []

    def writer(i):
        try:
            for j in range(5):
                cache.put_config(config_key("mttkrp", f"{i:012d}", j, 8, backend="cpu",
                                            spec=GPUSpec()), MemoryControllerConfig())
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(json.loads(cache_path().read_text())["configs"]) == 6 * 5


def test_cached_config_hit_miss_metrics_and_recalibration():
    ran = []

    def search():
        ran.append(1)
        return CFG_SMALL

    assert cached_config("mttkrp", "e" * 12, 0, 8, GPUSpec(), search) == CFG_SMALL
    assert cached_config("mttkrp", "e" * 12, 0, 8, GPUSpec(), search) == CFG_SMALL
    assert ran == [1]
    c = counters()
    assert c["autotune_cache.misses{kind=mttkrp}"] == 1 and c["autotune_cache.hits{kind=mttkrp}"] == 1
    # another spec is another key: searched again
    cached_config("mttkrp", "e" * 12, 0, 8, dataclasses.replace(GPUSpec(), hbm_bw=1e9), search)
    assert ran == [1, 1]


def test_resolve_spec_contract():
    assert resolve_spec("default") == GPUSpec()
    custom = dataclasses.replace(GPUSpec(), hbm_bw=1.0)
    assert resolve_spec(custom) is custom
    with pytest.raises(ValueError, match="unknown spec"):
        resolve_spec("warp-speed")
    with pytest.raises(ValueError, match="no fitted spec"):
        resolve_spec("measured", calibrate_on_miss=False)
    stored = dataclasses.replace(GPUSpec(), hbm_bw=9.9e11)
    AutotuneCache().put_spec(current_backend(), stored)
    assert resolve_spec("measured", calibrate_on_miss=False) == stored


# --- calibration on the CPU (an explicit device) -------------------------------


def test_fit_spec_fits_the_hbm_rate_to_hbm_bytes():
    """The PMS prices gathers and flushes at L2's rate: fit_spec takes
    their time (at the base spec's l2_bw) off each measured time, so the
    HBM rate is fitted to the HBM bytes alone, and L2 bytes the time does
    not cover are refused."""
    bw, pf, l2 = 3.0e12, 6.0e13, GPUSpec().l2_bw
    rows = [(b, f, lb) for b, f, lb in ((1e9, 1e10, 4e9), (5e9, 1e10, 1e9), (1e9, 8e10, 8e9))]
    fitted = fit_spec([CalibSample("x", ((b, f),), b / bw + f / pf + lb / l2, l2_bytes=lb)
                       for b, f, lb in rows])
    assert fitted.hbm_bw == pytest.approx(bw, rel=1e-9)
    assert fitted.peak_flops_f32 == pytest.approx(pf, rel=1e-9)
    assert fitted.l2_bw == l2
    with pytest.raises(ValueError, match="L2 bytes"):
        fit_spec([CalibSample("x", ((1e9, 1e9),), 1e-3, l2_bytes=l2 * 1e-3)])


def test_microbenchmarks_time_only_a_card():
    for measure in (measure_hbm_bw, measure_peak_flops_f32):
        with pytest.raises(ValueError, match="CUDA device"):
            measure(device="cpu")


def test_sweep_sample_counts_and_calibrate_and_store(tiny_tensor):
    """sweep_sample's counts are the workspace's unit-spec PMS counts; a
    stored calibration serves spec='measured' without calibrating again."""
    st = to_port(tiny_tensor)
    s = sweep_sample(st, 4, CFG_SMALL, reps=1, device="cpu")
    ws = make_planned_cp_als(st, 4, cfg=CFG_SMALL, device="cpu")
    assert s.per_mode == roofline_counts(ws) and s.measured_s > 0
    assert s.l2_bytes == l2_bytes(ws) == pytest.approx(
        sum(e.t_gather + e.t_flush for e in ws.pms_estimates().values()) * GPUSpec().l2_bw)
    assert s.label == "tiles=(32,16,64),blk=64"
    res = calibrate_and_store(preset="tiny", rank=4, cfgs=(CFG_SMALL, MemoryControllerConfig()),
                              reps=1, microbench=False, device="cpu")
    assert res.backend == "cpu" and len(res.samples) == 2 and len(res.validation) == 2
    assert res.residual_rel >= 0 and res.spec.hbm_bw > 0 and res.spec.peak_flops_f32 > 0
    assert AutotuneCache().get_spec("cpu") == res.spec


# --- obs.calibrate ------------------------------------------------------------


def test_calibration_rows_for_every_format(tiny_tensor):
    st = to_port(tiny_tensor)
    spaces = {"cp": make_planned_cp_als(st, 4, device="cpu"),
              "tucker": make_planned_tucker(st, (3, 5, 2), device="cpu"),
              "tt": make_planned_tt(st, (3, 5), device="cpu")}
    rows = []
    for fmt, ws in spaces.items():
        ests = ocal.pms_estimates(ws)
        assert sorted(ests) == [0, 1, 2]
        pred = ocal.predicted_sweep_seconds(ws)
        assert pred == pytest.approx(sum(e.t_total for e in ests.values()))
        row = ocal.calibration_row(ws, 2 * pred, format=fmt, preset="tiny")
        assert row.achieved_pct == pytest.approx(50.0)
        rows.append({"label": fmt, "preset": "tiny", "n_sweeps": 1, "measured_s": row.measured_s,
                     "predicted_s": row.predicted_s, "achieved_pct": row.achieved_pct})
    rows.append({"label": "none", "preset": "tiny", "n_sweeps": 0, "measured_s": 1.0,
                 "predicted_s": None, "achieved_pct": None})
    table = ocal.format_table(rows).splitlines()
    assert len(table) == 2 + len(rows) and "50.00%" in table[2]
    with pytest.raises(TypeError, match="pms_estimates"):
        ocal.pms_estimates(object())
    with pytest.raises(ValueError, match="measured_s"):
        ocal.calibration_row(spaces["cp"], 0.0, format="cp", preset="tiny")


# --- auto_tune on the planned paths -------------------------------------------


def reference_init(fmt, st, rank):
    key = jax.random.PRNGKey(0)
    if fmt == "cp":
        return [np.asarray(f) for f in random_factors(key, st.shape, rank)]
    if fmt == "tucker":
        return [np.asarray(f) for f in jax_init_tucker_factors(key, st.shape, rank)]
    return [np.asarray(c) for c in jax_init_tt_cores(key, st.shape, rank)]


RANKS = {"cp": {3: 4, 4: 4, 5: 4},
         "tucker": {3: (3, 5, 2), 4: (3, 4, 2, 3), 5: (2, 3, 2, 3, 2)},
         "tt": {3: (3, 5), 4: (3, 4, 2), 5: (2, 3, 2, 3)}}


@pytest.mark.parametrize("fmt", ["cp", "tucker", "tt"])
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_auto_tuned_fits_match_the_chosen_config_and_the_reference(request, fixture, fmt):
    st = request.getfixturevalue(fixture)
    tst = to_port(st)
    rank = RANKS[fmt][st.nmodes]
    init = reference_init(fmt, st, rank)
    kw = dict(format=fmt, iters=ITERS, init_factors=factors_from_numpy(init, "cpu"), device="cpu")
    make_planned = {"cp": make_planned_cp_als, "tucker": make_planned_tucker, "tt": make_planned_tt}
    ws = make_planned[fmt](tst, rank, auto_tune=True, device="cpu")
    chosen = {op.cfg for op in ws.ops.values()}
    assert len(chosen) == 1  # every mode picks the same geometry on these tensors
    cfg = chosen.pop()
    tuned = decompose(tst, rank, auto_tune=True, **kw).fit_history
    fixed = decompose(tst, rank, cfg=cfg, **kw).fit_history
    assert len(tuned) == ITERS
    np.testing.assert_allclose(tuned, fixed, rtol=0, atol=FIT_TOL)
    c = cfg.cache
    jcfg = JConfig(cache=JCache(tile_i=c.tile_i, tile_j=c.tile_j, tile_k=c.tile_k),
                   dma=JDMA(blk=cfg.dma.blk))
    assert config_from_reference(jconfig_to_dict(jcfg)) == cfg
    ref_kw = {"init": "random"} if fmt == "tt" else {}  # the draws reference_init makes
    ref = jax_decompose(st, rank, format=fmt, method="pallas", iters=ITERS, cfg=jcfg, seed=0,
                        **ref_kw)
    np.testing.assert_allclose(tuned, ref.fit_history, rtol=0, atol=FIT_TOL)


@pytest.mark.parametrize("fmt,rank", [("cp", 4), ("tucker", (3, 3, 3)), ("tt", (3, 3))])
def test_decompose_cached_warm_hit_evaluates_nothing(tiny_tensor, fmt, rank):
    st = to_port(tiny_tensor)
    fresh = decompose(st, rank, format=fmt, iters=2, seed=0, auto_tune=True, device="cpu")
    decompose(st, rank, format=fmt, iters=2, seed=0, auto_tune="cached", device="cpu")
    metrics.reset()
    warm = decompose(st, rank, format=fmt, iters=2, seed=0, auto_tune="cached", device="cpu")
    c = counters()
    assert not any(k.startswith(("pms.configs_evaluated", "pms.searches")) for k in c), c
    assert sum(v for k, v in c.items() if k.startswith("autotune_cache.hits")) == st.nmodes
    assert fresh.fit_history == warm.fit_history


def test_auto_tune_contracts(tiny_tensor):
    st = to_port(tiny_tensor)
    with pytest.raises(ValueError, match="auto_tune"):
        decompose(st, 4, auto_tune="always", device="cpu")
    with pytest.raises(ValueError, match="auto_tune"):
        make_planned_cp_als(st, 4, auto_tune="yes", device="cpu")
    # cfg is ignored when the PMS picks; a prebuilt workspace is taken as it is
    ws = make_planned_cp_als(st, 4, cfg=CFG_SMALL, auto_tune=True, device="cpu")
    assert all(op.cfg != CFG_SMALL for op in ws.ops.values())
    ws = make_planned_cp_als(st, 4, cfg=CFG_SMALL, device="cpu")
    state = decompose(st, 4, iters=1, planned=ws, auto_tune=True, device="cpu")
    assert len(state.fit_history) == 1
