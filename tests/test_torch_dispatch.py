"""The one-shot dispatchers (`mttkrp_auto`, `tucker_auto`, `tt_auto`) and
their plan cache against the JAX package's (Pallas in interpret mode, as
the reference's own tests run it), and `decompose(method=)`."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
import repro_torch.kernels.ops as tops
from repro.core.coo import synthetic_tensor
from repro_torch.api import decompose
from repro_torch.core import coo as tcoo
from repro_torch.core.cp_als import cp_als
from repro_torch.core.memctrl import DMAEngineConfig, MemoryControllerConfig
from repro_torch.obs import metrics
from repro_torch.tt import tt_als
from repro_torch.tucker import tucker_hooi
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
# float32 sums over the same terms in another order.
TOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_caches():
    """Both packages' plan caches empty, at their default bound, before and
    after each test."""
    caps = jops.plan_cache_config(), tops.plan_cache_config()
    for ops in (jops, tops):
        ops.plan_cache_clear()
    yield
    for ops, cap in zip((jops, tops), caps):
        ops.plan_cache_clear()
        ops.plan_cache_config(cap)


@pytest.fixture(scope="module")
def small():
    """Small enough that the interpret-mode kernels take a fraction of a
    second a call."""
    return synthetic_tensor((30, 20, 25), 300, seed=4, skew=0.5)


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


def assert_cols_close(got, want, tol=TOL):
    """Largest error relative to each output column's max."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    assert (np.abs(got - want).max(axis=0) / scale).max() <= tol


def factors(shape, ranks, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, ranks)]


def tt_cores(shape, tt_ranks, seed=0):
    rng = np.random.default_rng(seed)
    bonds = (1,) + tuple(tt_ranks) + (1,)
    return [rng.standard_normal((bonds[k], s, bonds[k + 1])).astype(np.float32)
            for k, s in enumerate(shape)]


def tt_cores_t(shape):
    return [torch.from_numpy(c) for c in tt_cores(shape, (2, 2))]


@pytest.mark.parametrize("method", ["pallas", "approach1", "approach2"])
def test_mttkrp_auto_matches_reference(small, method):
    """Every mode, on the stream as given (unsorted: approach 1 takes the
    general path) and sorted by the mode (approach 1's segmented sum)."""
    facs = factors(small.shape, (3, 3, 3))
    for st in (small, small.sorted_by(1)):
        for mode in range(st.nmodes):
            want = jops.mttkrp_auto(st, [jnp.asarray(f) for f in facs], mode, method=method)
            got = tops.mttkrp_auto(to_port(st), [torch.from_numpy(f) for f in facs], mode,
                                   method=method, device="cpu")
            assert got.shape == (st.shape[mode], 3)
            assert_cols_close(got, want)


@pytest.mark.parametrize("method", ["pallas", "reference"])
def test_tucker_auto_matches_reference(small, method):
    facs = factors(small.shape, (3, 4, 2), seed=1)
    for mode in range(small.nmodes):
        want = jops.tucker_auto(small, [jnp.asarray(f) for f in facs], mode, method=method)
        got = tops.tucker_auto(to_port(small), [torch.from_numpy(f) for f in facs], mode,
                               method=method, device="cpu")
        assert got.shape == (small.shape[mode], (8, 6, 12)[mode])
        assert_cols_close(got, want)


@pytest.mark.parametrize("method", ["pallas", "reference"])
def test_tt_auto_matches_reference(small, method):
    cores = tt_cores(small.shape, (3, 2), seed=2)
    widths = (1 * 3, 3 * 2, 2 * 1)
    for mode in range(small.nmodes):
        want = jops.tt_auto(small, [jnp.asarray(c) for c in cores], mode, method=method)
        got = tops.tt_auto(to_port(small), [torch.from_numpy(c) for c in cores], mode,
                           method=method, device="cpu")
        assert got.shape == (small.shape[mode], widths[mode])
        assert_cols_close(got, want)


def call_sequence(ops, st, facs, tfacs, cores, device_kw):
    """One call sequence over the three kinds, modes, ranks and configs,
    under an LRU bound of 3; returns the stats after each call."""
    blk128 = MemoryControllerConfig(dma=DMAEngineConfig(blk=128))
    if ops is jops:
        from repro.core.memctrl import DMAEngineConfig as JDMA
        from repro.core.memctrl import MemoryControllerConfig as JMC

        blk128 = JMC(dma=JDMA(blk=128))
    ops.plan_cache_config(3)
    seen = []
    calls = [
        lambda: ops.mttkrp_auto(st, facs, 0, **device_kw),             # miss
        lambda: ops.mttkrp_auto(st, facs, 0, **device_kw),             # hit
        lambda: ops.mttkrp_auto(st, facs, 1, **device_kw),             # miss
        lambda: ops.tucker_auto(st, tfacs, 0, **device_kw),            # miss: kinds never alias
        lambda: ops.mttkrp_auto(st, facs, 0, cfg=blk128, **device_kw), # miss, evicts mode 0
        lambda: ops.mttkrp_auto(st, facs, 1, **device_kw),             # hit
        lambda: ops.tt_auto(st, cores, 2, **device_kw),                # miss, evicts the ttmc op
        lambda: ops.tucker_auto(st, tfacs, 0, **device_kw),            # miss again
        lambda: ops.mttkrp_auto(st, [f[:, :2] for f in facs], 1, **device_kw),  # another rank: miss
        lambda: ops.tt_auto(st, cores, 2, **device_kw),                # hit
    ]
    for call in calls:
        call()
        seen.append(ops.plan_cache_stats())
    ops.plan_cache_config(1)  # shrinking evicts down to the bound
    seen.append(ops.plan_cache_stats())
    return seen


def test_plan_cache_stats_match_reference(small):
    """The same call sequence gives the reference's hits, misses,
    evictions, size, bound and per-kind counts after every call."""
    facs, tfacs = factors(small.shape, (3, 3, 3)), factors(small.shape, (3, 4, 2))
    cores = tt_cores(small.shape, (3, 2))
    want = call_sequence(jops, small, [jnp.asarray(f) for f in facs],
                         [jnp.asarray(f) for f in tfacs], [jnp.asarray(c) for c in cores], {})
    got = call_sequence(tops, to_port(small), [torch.from_numpy(f) for f in facs],
                        [torch.from_numpy(f) for f in tfacs], [torch.from_numpy(c) for c in cores],
                        {"device": "cpu"})
    assert got == want
    assert got[-1]["evictions"] > got[-2]["evictions"] and got[-1]["size"] == 1
    tops.plan_cache_clear()
    assert tops.plan_cache_stats() == {"hits": 0, "misses": 0, "evictions": 0, "size": 0,
                                       "maxsize": 1,
                                       "by_kind": {k: {"hits": 0, "misses": 0}
                                                   for k in ("mttkrp", "ttmc", "tt")}}


def test_cache_hit_builds_nothing_and_counts(small, monkeypatch):
    """A hit returns the cached op without a plan build and records
    `plan_cache.*` metrics; REPRO_VALIDATE_PLANS validates the cached plan
    again on a hit."""
    st = to_port(small)
    built, validated = [], []
    real_build, real_validate = tops.make_planned_mttkrp, tops.validate_plan
    monkeypatch.setattr(tops, "make_planned_mttkrp", lambda *a, **k: built.append(a) or real_build(*a, **k))
    monkeypatch.setattr(tops, "validate_plan", lambda p: validated.append(p) or real_validate(p))
    metrics.reset()
    facs = [torch.ones((s, 4)) for s in st.shape]
    a = tops.mttkrp_auto(st, facs, 2, device="cpu")
    b = tops.mttkrp_auto(st, facs, 2, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(built) == 1 and validated == []
    monkeypatch.setenv("REPRO_VALIDATE_PLANS", "1")
    tops.mttkrp_auto(st, facs, 2, device="cpu")
    assert len(built) == 1 and len(validated) == 1
    counters = metrics.snapshot()["counters"]
    assert counters["plan_cache.hits{kind=mttkrp}"] == 2
    assert counters["plan_cache.misses{kind=mttkrp}"] == 1
    hists = metrics.snapshot()["histograms"]
    assert hists["plan_cache.miss_build_seconds{kind=mttkrp}"]["count"] == 1
    assert hists["plan_cache.hit_seconds{kind=mttkrp}"]["count"] == 2


def test_plan_cache_bound_from_the_environment():
    """REPRO_PLAN_CACHE_MAX sets the bound when the module is imported, as
    in the reference; plan_cache_config refuses a bound below 1."""
    code = "from repro_torch.kernels.ops import plan_cache_config as c; print(c())"
    env = {"PYTHONPATH": str(ROOT / "src"), "REPRO_PLAN_CACHE_MAX": "5", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "5"
    with pytest.raises(ValueError, match=">= 1"):
        tops.plan_cache_config(0)


def test_dispatcher_contracts(small):
    st = to_port(small)
    facs = [torch.ones((s, 2)) for s in st.shape]
    for call in (lambda: tops.mttkrp_auto(st, facs, 0, method="reference", device="cpu"),
                 lambda: tops.tucker_auto(st, facs, 0, method="approach1", device="cpu"),
                 lambda: tops.tt_auto(st, tt_cores_t(st.shape), 0, method="approach2", device="cpu")):
        with pytest.raises(ValueError, match="unknown method"):
            call()
    with pytest.raises(ValueError, match="not sorted"):
        tops.mttkrp_auto(st, facs, 0, method="approach1", sorted_by_mode=True, device="cpu")
    assert tops.plan_cache_stats()["size"] == 0


def test_decompose_method(tiny_tensor):
    """decompose(method=) runs each format's non-planned method: the same
    run as the driver called directly."""
    st = to_port(tiny_tensor)
    init = [torch.from_numpy(f) for f in factors(st.shape, (3, 3, 3), seed=5)]
    for method in ("approach1", "approach2"):
        for layout in ("remap", "copies"):
            a = decompose(st, 3, method=method, layout=layout, iters=2, init_factors=init, device="cpu")
            b = cp_als(st, 3, method=method, layout=layout, iters=2, init_factors=init, device="cpu")
            assert a.fit_history == b.fit_history
    a = decompose(st, (3, 4, 2), format="tucker", method="reference", iters=2, device="cpu")
    b = tucker_hooi(st, (3, 4, 2), method="reference", iters=2, device="cpu")
    assert a.fit_history == b.fit_history
    a = decompose(st, (3, 4), format="tt", method="reference", iters=2, device="cpu")
    b = tt_als(st, (3, 4), method="reference", iters=2, device="cpu")
    assert a.fit_history == b.fit_history
    for fmt, rank in (("cp", 3), ("tucker", 3), ("tt", 3)):
        with pytest.raises(ValueError, match="unknown method"):
            decompose(st, rank, format=fmt, method="pallas_mesh", iters=1, device="cpu")
        with pytest.raises(ValueError, match="devices=/dist="):
            decompose(st, rank, format=fmt, method="pallas_sharded", iters=1, device="cpu")
