"""The port's resilience layer (`repro_torch.resilience`,
`repro_torch.testing.faults`), case for case with tests/test_resilience.py:
numerical guards in the planned drive loop, plan validation, device-memory
admission with the ladder, checkpoint/resume of a killed sweep, and the
bounded plan cache.  The reference's sharded dead-shard case is in
tests/test_torch_sharded.py.

Then parity with `repro`: GuardState reasons and DecompositionDiverged
messages for the same fit sequences; `plan_stream`, the layouts' bytes and
the reference footprint to the bit; restart histories (both packages'
`drive` given the same numpy `reinit=` arrays) and fallback histories
within 1e-5 of the reference's, from its initial factors (Tucker by its
fits: its factors carry eigh's sign).  On the CPU every plain path is
deterministic, so a resumed run equals the clean one to 1e-6."""
import math
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import decompose as jax_decompose
from repro.core.coo import random_factors
from repro.core.loop import DecompositionDiverged as JaxDiverged
from repro.core.loop import GuardConfig as JaxGuardConfig
from repro.core.loop import GuardState as JaxGuardState
from repro.core.loop import finish_iter as jax_finish_iter
from repro.core.remap import plan_blocks as jax_plan_blocks
from repro.kernels.ops import make_planned_cp_als as jax_make_cp
from repro.kernels.workspace import plan_stream as jax_plan_stream
from repro.resilience import reference_footprint_bytes as jax_reference_footprint_bytes
from repro.testing import faults as jax_faults
from repro.tt import init_tt_cores as jax_init_tt_cores
from repro.tt.als import core_to_matrix as jax_core_to_matrix
from repro.tt.als import make_planned_tt as jax_make_tt
from repro.tucker import init_tucker_factors as jax_init_tucker_factors
from repro.tucker.hooi import make_planned_tucker as jax_make_tucker
from repro_torch.api import _lane_ranks, decompose
from repro_torch.core import coo as tcoo
from repro_torch.core.loop import GuardConfig, GuardState, finish_iter
from repro_torch.core.memctrl import MemoryControllerConfig
from repro_torch.core.remap import plan_blocks
from repro_torch.kernels import ops
from repro_torch.kernels.ops import make_planned_cp_als
from repro_torch.kernels.workspace import plan_stream
from repro_torch.obs import metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience import (
    AdmissionError,
    DecompositionDiverged,
    PlanValidationError,
    admission_bytes,
    admit,
    plan_with_budget,
    plans_validated,
    reference_footprint_bytes,
    validate_plan,
)
from repro_torch.testing import faults
from repro_torch.train import CheckpointManager
from repro_torch.tt import make_planned_tt
from repro_torch.tucker import make_planned_tucker
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 5
PARITY_TOL = 1e-5  # fits against the reference: float32 sums in another order
RESUME_TOL = 1e-6
CPU = torch.device("cpu")
MAKE = {"cp": make_planned_cp_als, "tucker": make_planned_tucker, "tt": make_planned_tt}
RANKS = {"cp": 8, "tucker": (4, 4, 4), "tt": (4, 3)}


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


@pytest.fixture(scope="module")
def tiny(tiny_tensor):
    return to_port(tiny_tensor)


def _clean(st, rank=8, **kw):
    return decompose(st, rank, iters=ITERS, seed=0, device="cpu", **kw)


# ---------------------------------------------------------------------------
# finish_iter NaN semantics (guards off)
# ---------------------------------------------------------------------------


def test_finish_iter_nonfinite_stops_and_warns():
    fits: list = []
    with pytest.warns(RuntimeWarning, match="non-finite fit") as got:
        stop = finish_iter(fits, float("nan"), 0, None, False, "unit")
    assert stop is True
    assert len(fits) == 1 and not np.isfinite(fits[0])
    with pytest.warns(RuntimeWarning) as want:
        jax_finish_iter([], float("nan"), 0, None, False, "unit")
    assert str(got[0].message) == str(want[0].message)  # it names guards=GuardConfig(...)


def test_guards_off_nan_terminates_loop(tiny):
    ws = make_planned_cp_als(tiny, 8, device="cpu")
    faults.inject_nan_factor(ws, at_iter=1)
    with pytest.warns(RuntimeWarning, match="non-finite fit"):
        out = decompose(tiny, 8, iters=ITERS, seed=0, planned=ws, device="cpu")
    assert len(out.fit_history) < ITERS
    assert not np.isfinite(out.fit_history[-1])


# ---------------------------------------------------------------------------
# GuardConfig / drive-extras contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [dict(policy="retry"), dict(divergence_patience=0),
                                 dict(max_restarts=-1), dict(check_factors_every=-1)])
def test_guard_config_validation(bad):
    with pytest.raises(ValueError):
        GuardConfig(**bad)


def test_guard_state_regression_patience():
    gs = GuardState(GuardConfig(divergence_patience=2))
    assert gs.observe_fit(0.5) is None
    assert gs.observe_fit(0.3) is None  # streak 1
    reason = gs.observe_fit(0.2)  # streak 2: fires
    assert reason is not None and "regressed" in reason
    gs.reset()
    assert gs.observe_fit(0.1) is None


@pytest.mark.parametrize("fmt,method", [("cp", "approach1"), ("cp", "approach2"),
                                        ("tucker", "reference"), ("tt", "reference")])
def test_guards_rejected_on_reference_methods(tiny, fmt, method):
    with pytest.raises(ValueError, match="guards"):
        decompose(tiny, RANKS[fmt], format=fmt, iters=2, method=method, guards=GuardConfig(),
                  device="cpu")


def test_guards_rejected_beside_mttkrp_fn(tiny):
    """The reference folds `mttkrp_fn` into `jit_sweep`: it runs the
    per-mode loop, which has no guards."""
    ws = make_planned_cp_als(tiny, 8, device="cpu")
    with pytest.raises(ValueError, match="mttkrp_fn"):
        decompose(tiny, 8, iters=2, mttkrp_fn=ws.mttkrp_fn, checkpoint_path="unused",
                  device="cpu")


def test_checkpoint_every_requires_path(tiny):
    with pytest.raises(ValueError, match="checkpoint"):
        decompose(tiny, 8, iters=2, checkpoint_every=2, device="cpu")


# ---------------------------------------------------------------------------
# Guard policies: detect and recover
# ---------------------------------------------------------------------------


def test_raise_policy_detects_nan(tiny):
    ws = make_planned_cp_als(tiny, 8, device="cpu")
    faults.inject_nan_factor(ws, at_iter=1)
    with pytest.raises(DecompositionDiverged) as ei:
        decompose(tiny, 8, iters=ITERS, seed=0, planned=ws, guards=GuardConfig(policy="raise"),
                  device="cpu")
    assert "non-finite fit" in str(ei.value)
    assert ei.value.fit_history


def test_factor_cadence_check_fires_at_injection_iter(tiny):
    """check_factors_every=1 catches the poison in the iteration it lands,
    one earlier than the fit guard."""
    ws = make_planned_cp_als(tiny, 8, device="cpu")
    faults.inject_nan_factor(ws, at_iter=1)
    with pytest.raises(DecompositionDiverged) as ei:
        decompose(tiny, 8, iters=ITERS, seed=0, planned=ws,
                  guards=GuardConfig(policy="raise", check_factors_every=1), device="cpu")
    assert ei.value.iteration == 1
    assert "factor" in ei.value.reason


@pytest.mark.parametrize("policy", ["restart", "fallback"])
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_recovery_matches_clean_run(request, fixture, policy):
    """Restart and fallback recover to a final fit within 1e-5 of the
    uninjected run on the 3/4/5-mode fixtures."""
    st = to_port(request.getfixturevalue(fixture))
    clean = _clean(st)
    ws = make_planned_cp_als(st, 8, device="cpu")
    faults.inject_nan_factor(ws, at_iter=1)
    out = decompose(st, 8, iters=ITERS, seed=0, planned=ws, guards=GuardConfig(policy=policy),
                    device="cpu")
    assert abs(out.fit_history[-1] - clean.fit_history[-1]) < 1e-5


@pytest.mark.parametrize("policy", ["restart", "fallback"])
@pytest.mark.parametrize("fmt", ["tucker", "tt"])
def test_recovery_other_formats(tiny, fmt, policy):
    clean = decompose(tiny, RANKS[fmt], format=fmt, iters=ITERS, seed=0, device="cpu")
    ws = MAKE[fmt](tiny, RANKS[fmt], device="cpu")
    faults.inject_nan_factor(ws, at_iter=1)
    out = decompose(tiny, RANKS[fmt], format=fmt, iters=ITERS, seed=0, planned=ws,
                    guards=GuardConfig(policy=policy), device="cpu")
    assert abs(out.fit_history[-1] - clean.fit_history[-1]) < 1e-5


def test_restart_budget_exhausted(tiny):
    """A fault that fires on every attempt exhausts max_restarts and
    escalates instead of looping for ever."""
    ws = make_planned_cp_als(tiny, 8, device="cpu")
    inner = ws._sweep_call

    def always_poisoned(facs, *args, it):
        facs, aux, fit = inner(facs, *args, it=it)
        return facs, aux, fit * torch.nan

    ws._sweep_call = always_poisoned
    with pytest.raises(DecompositionDiverged, match="restart budget"):
        decompose(tiny, 8, iters=ITERS, seed=0, planned=ws,
                  guards=GuardConfig(policy="restart", max_restarts=1), device="cpu")


def test_fallback_launches_no_kernel_and_records_it(tiny):
    """After the switch no kernel launches (the reference sweep runs the
    plain approach 1), and the switch is an event, a counter and a line."""
    metrics.reset()
    ws = make_planned_cp_als(tiny, 8, device="cpu")
    faults.inject_nan_factor(ws, at_iter=1)
    launches = []
    inner = ws._sweep_call

    def counted(facs, *args, it):
        launches.append(it)
        return inner(facs, *args, it=it)

    ws._sweep_call = counted
    with obs_trace.tracing(True) as tr:
        decompose(tiny, 8, iters=ITERS, seed=0, planned=ws, guards=GuardConfig(policy="fallback"),
                  device="cpu")
    assert launches == [0, 1, 2]  # the planned sweep ran until the fit guard fired at 2
    events = tr.events("guard_fallback")
    assert len(events) == 1 and events[0]["args"]["it"] == 2
    assert metrics.snapshot()["counters"]["resilience.fallbacks{label=cp_als}"] == 1


def test_guard_never_catches_a_kernel_error(tiny, monkeypatch):
    """Only a numerical divergence fires a guard: an exception from the
    kernel path passes through every policy."""
    ws = make_planned_cp_als(tiny, 8, device="cpu")

    def broken(*_a, **_k):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(ops, "mttkrp_blocked", broken)
    for policy in ("raise", "restart", "fallback"):
        with pytest.raises(RuntimeError, match="failed to launch"):
            decompose(tiny, 8, iters=ITERS, seed=0, planned=ws, guards=GuardConfig(policy=policy),
                      device="cpu")


# ---------------------------------------------------------------------------
# Plan validation
# ---------------------------------------------------------------------------


def _tiny_plan(st):
    return plan_blocks(st, 0, tile_i=256, blk=64, in_tiles=(256, 256), device="cpu")


def test_validate_plan_passes_good_plan(tiny):
    validate_plan(_tiny_plan(tiny))


def test_validate_plan_catches_corrupted_iloc(tiny):
    plan = _tiny_plan(tiny)
    bad = faults.corrupt_plan(plan)
    assert int(plan.iloc[0]) != plan.tile_i  # the original is untouched
    with pytest.raises(PlanValidationError, match="iloc"):
        validate_plan(bad)


def test_plans_validated_env_gate(monkeypatch):
    monkeypatch.delenv("REPRO_VALIDATE_PLANS", raising=False)
    assert not plans_validated()
    for v in ("1", "true", "YES", "on"):
        monkeypatch.setenv("REPRO_VALIDATE_PLANS", v)
        assert plans_validated()
    monkeypatch.setenv("REPRO_VALIDATE_PLANS", "0")
    assert not plans_validated()


def test_build_time_validation_accepts_real_plans(tiny, monkeypatch):
    monkeypatch.setenv("REPRO_VALIDATE_PLANS", "1")
    _tiny_plan(tiny)


def test_cache_hit_revalidates_resident_plan(tiny, monkeypatch):
    """REPRO_VALIDATE_PLANS=1 catches a plan corrupted after it entered the
    cache: the hit path validates again."""
    ops.plan_cache_clear()
    args = ("mttkrp", tiny, 0, 8, None, CPU)
    op = ops._planned_cached(*args, lambda: ops.make_planned_mttkrp(tiny, 0, 8, device="cpu"))
    op.plan = faults.corrupt_plan(op.plan)
    monkeypatch.setenv("REPRO_VALIDATE_PLANS", "1")
    with pytest.raises(PlanValidationError):
        ops._planned_cached(*args, lambda: pytest.fail("must be a cache hit"))
    ops.plan_cache_clear()


# ---------------------------------------------------------------------------
# Bounded plan cache
# ---------------------------------------------------------------------------


def test_plan_cache_config_rejects_nonpositive():
    with pytest.raises(ValueError):
        ops.plan_cache_config(0)


def test_plan_cache_churn_is_bounded(tiny):
    old = ops.plan_cache_config()
    ops.plan_cache_clear()
    try:
        ops.plan_cache_config(4)
        for mode in range(10):
            ops._planned_cached("mttkrp", tiny, mode, 8, None, CPU, lambda: object())
        stats = ops.plan_cache_stats()
        assert stats["size"] <= 4 and stats["maxsize"] == 4 and stats["evictions"] >= 6
    finally:
        ops.plan_cache_config(old)
        ops.plan_cache_clear()


def test_plan_cache_config_evicts_down(tiny):
    old = ops.plan_cache_config()
    ops.plan_cache_clear()
    try:
        for mode in range(6):
            ops._planned_cached("mttkrp", tiny, mode, 8, None, CPU, lambda: object())
        ops.plan_cache_config(2)
        assert ops.plan_cache_stats()["size"] <= 2
    finally:
        ops.plan_cache_config(old)
        ops.plan_cache_clear()


# ---------------------------------------------------------------------------
# Device-memory admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["cp", "tucker", "tt"])
def test_admission_bytes_report(tiny, fmt):
    ws = MAKE[fmt](tiny, RANKS[fmt], device="cpu")
    rep = admission_bytes(ws)
    assert set(rep) == {"plan_bytes", "factor_bytes", "smem_bytes", "total_bytes"}
    assert rep["total_bytes"] == rep["plan_bytes"] + rep["factor_bytes"] + rep["smem_bytes"]
    assert all(v > 0 for v in rep.values())
    assert rep["smem_bytes"] == ws.smem_model_bytes()


def test_admit_rejects_shrunk_budget(tiny):
    ws = make_planned_cp_als(tiny, 8, device="cpu")
    budget = faults.shrunk_budget(ws)
    with pytest.raises(AdmissionError) as ei:
        admit(ws, budget)
    assert ei.value.budget_bytes == budget
    admit(ws, admission_bytes(ws)["total_bytes"])  # an exact fit admits


@pytest.fixture(scope="module")
def scattered():
    """A tensor of many small tile groups, where a smaller block pads less.
    (The reference's test steps down on the tiny tensor, whose one group
    pads alike at every block size: there its VMEM term shrinks with the
    block, while the port's kernels keep the same shared memory.)"""
    return tcoo.synthetic_tensor((2048, 2048, 2048), 6_000, seed=5, skew=0.0)


def test_ladder_steps_down_blk(scattered):
    """One byte under the default-block footprint admits at a smaller block
    (less per-group padding, smaller layouts)."""
    build = lambda c: make_planned_cp_als(scattered, 8, cfg=c, device="cpu")  # noqa: E731
    top_blk = MemoryControllerConfig().dma.blk
    top_total = admission_bytes(build(None))["total_bytes"]
    ws, decision = plan_with_budget(build, top_total - 1)
    assert ws is not None
    assert decision["admitted"] == "pallas" and decision["blk"] == top_blk // 2
    assert len(decision["ladder"]) == 2


def test_ladder_degrades_to_reference(tiny):
    """A budget under every planned rung but over the raw stream's footprint
    routes decompose() to the reference method."""
    ref = reference_footprint_bytes(tiny, (8, 8, 8))
    budget = ref + 10_000
    metrics.reset()
    with obs_trace.tracing(True) as tr:
        out = decompose(tiny, 8, iters=3, seed=0, hbm_budget=budget, device="cpu")
    want = decompose(tiny, 8, iters=3, seed=0, method="approach1", device="cpu")
    assert abs(out.fit_history[-1] - want.fit_history[-1]) < 1e-5
    assert len(tr.spans("admission_ladder")) == 1
    rungs = [r["args"] for r in tr.events("admission_rung")]
    assert [r["outcome"] for r in rungs] == ["over_budget"] * 6 + ["reference"]
    assert [r["blk"] for r in rungs[:-1]] == [256, 128, 64, 32, 16, 8]
    assert metrics.snapshot()["counters"]["admission.admitted{outcome=reference}"] == 1


def test_impossible_budget_raises_with_ladder(tiny):
    with pytest.raises(AdmissionError) as ei:
        decompose(tiny, 8, iters=3, hbm_budget=1_000, device="cpu")
    assert ei.value.ladder
    assert ei.value.reference_bytes > 1_000


def test_budget_incompatible_with_auto_tune(tiny):
    with pytest.raises(ValueError, match="auto_tune"):
        decompose(tiny, 8, iters=2, hbm_budget=10**9, auto_tune=True, device="cpu")


# ---------------------------------------------------------------------------
# Checkpoint/resume: kill a sweep, resume it
# ---------------------------------------------------------------------------

_KILLED_SWEEP = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.api import decompose
from repro_torch.core.coo import synthetic_tensor
from repro_torch.testing import faults
from repro_torch.{module} import {make}
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
st = synthetic_tensor((64, 48, 80), 2_000, seed=0, skew=0.8)
ws = {make}(st, {rank!r}, device="cpu")
faults.kill_at(ws, at_iter=3)
decompose(st, {rank!r}, format={fmt!r}, iters=5, seed=0, planned=ws, checkpoint_path={ckpt!r},
          device="cpu")
"""

_BUILDERS = {"cp": ("kernels.ops", "make_planned_cp_als"),
             "tucker": ("tucker.hooi", "make_planned_tucker"),
             "tt": ("tt.als", "make_planned_tt")}


@pytest.mark.parametrize("fmt", ["cp", "tucker", "tt"])
def test_killed_sweep_resumes_to_clean_parity(tiny, tmp_path, fmt):
    """Kill the sweep (os._exit) before iteration 3 in a process that
    imports no JAX, resume from the surviving checkpoints, and hold the
    whole fit history to the uninterrupted run's to 1e-6."""
    module, make = _BUILDERS[fmt]
    code = _KILLED_SWEEP.format(src=os.path.join(ROOT, "src"), module=module, make=make,
                                rank=RANKS[fmt], fmt=fmt, ckpt=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 17, (
        f"expected the kill_at exit code, got {proc.returncode}\n"
        f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-3000:]}")
    assert CheckpointManager(str(tmp_path), keep=2).latest_step() == 2
    metrics.reset()
    resumed = decompose(tiny, RANKS[fmt], format=fmt, iters=ITERS, seed=0,
                        checkpoint_path=str(tmp_path), device="cpu")
    clean = decompose(tiny, RANKS[fmt], format=fmt, iters=ITERS, seed=0, device="cpu")
    assert len(resumed.fit_history) == len(clean.fit_history)
    deltas = [abs(a - b) for a, b in zip(resumed.fit_history, clean.fit_history)]
    assert max(deltas) < RESUME_TOL, deltas
    label = {"cp": "cp_als", "tucker": "tucker_hooi", "tt": "tt_als"}[fmt]
    assert metrics.snapshot()["counters"][f"resilience.resumes{{label={label}}}"] == 1


def test_resume_restores_saved_factors_bit_for_bit(tiny, tmp_path):
    """The restored padded factors and fits are the saved ones, exactly."""
    ws = make_planned_cp_als(tiny, 8, device="cpu")
    decompose(tiny, 8, iters=2, seed=0, planned=ws, checkpoint_path=str(tmp_path), device="cpu")
    _, saved = CheckpointManager(str(tmp_path)).restore()
    seen = {}
    inner = ws._sweep_call

    def first_input(facs, *args, it):
        seen.setdefault("facs", tuple(f.clone() for f in facs))
        return inner(facs, *args, it=it)

    ws._sweep_call = first_input
    out = decompose(tiny, 8, iters=3, seed=0, planned=ws, checkpoint_path=str(tmp_path),
                    device="cpu")
    for got, want in zip(seen["facs"], saved["facs"]):
        assert torch.equal(got, want)
    assert out.fit_history[:2] == saved["fits"].tolist()


def test_resume_rejects_mismatched_shapes(tiny, tmp_path):
    """A checkpoint of another rank fails loudly."""
    decompose(tiny, 8, iters=2, seed=0, checkpoint_path=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        decompose(tiny, 4, iters=4, seed=0, checkpoint_path=str(tmp_path), device="cpu")


def test_checkpoint_every_cadence(tiny, tmp_path):
    """checkpoint_every=2 writes at iterations 1, 3 and the last."""
    with obs_trace.tracing(True) as tr:
        decompose(tiny, 8, iters=5, seed=0, checkpoint_path=str(tmp_path), checkpoint_every=2,
                  device="cpu")
    steps = CheckpointManager(str(tmp_path), keep=2).all_steps()
    assert steps and steps[-1] == 4
    saves = [r["args"]["it"] for r in tr.spans("checkpoint_save")]
    assert saves == [1, 3, 4]


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------

_FITS = [
    [0.5, 0.3, 0.2],
    [0.1, 0.2, float("nan")],
    [0.1, float("inf")],
    [0.2, 0.2 - 5e-7, 0.2 - 2e-6, 0.19, 0.18, 0.17],
    [0.3, 0.1, 0.4, 0.2, 0.1, 0.05],
]


@pytest.mark.parametrize("patience", [1, 2, 3])
@pytest.mark.parametrize("fits", _FITS, ids=range(len(_FITS)))
def test_guard_state_and_messages_match_reference(fits, patience):
    ours = GuardState(GuardConfig(divergence_patience=patience))
    ref = JaxGuardState(JaxGuardConfig(divergence_patience=patience))
    for k, f in enumerate(fits):
        got, want = ours.observe_fit(f), ref.observe_fit(f)
        assert got == want, (k, got, want)
        if got is not None:
            assert (str(DecompositionDiverged("cp_als", k, got, fits[: k + 1]))
                    == str(JaxDiverged("cp_als", k, want, fits[: k + 1])))


@pytest.mark.parametrize("fixture,mode,blk", [("tiny_tensor", 0, 64), ("tiny_tensor", 2, 256),
                                              ("tensor4d", 1, 128), ("tensor5d", 3, 32)])
def test_plan_stream_and_layout_bytes_match_reference(request, fixture, mode, blk):
    st = request.getfixturevalue(fixture)
    n_in = st.nmodes - 1
    kw = dict(tile_i=64, blk=blk, in_tiles=(32,) * n_in)
    ref_idx, ref_val = jax_plan_stream(jax_plan_blocks(st, mode, **kw))
    idx, val = plan_stream(plan_blocks(to_port(st), mode, device="cpu", **kw))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(val.numpy(), np.asarray(ref_val))
    assert (make_planned_cp_als(to_port(st), 8, device="cpu").plan_bytes()
            == jax_make_cp(st, 8).plan_bytes())


@pytest.mark.parametrize("fmt", ["cp", "tucker", "tt"])
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_reference_footprint_matches_reference(request, fixture, fmt):
    st = request.getfixturevalue(fixture)
    rank = {"cp": 8, "tucker": (3,) * st.nmodes, "tt": (3,) * (st.nmodes - 1)}[fmt]
    lanes = _lane_ranks(fmt, rank, st.nmodes)
    assert reference_footprint_bytes(to_port(st), lanes) == jax_reference_footprint_bytes(st, lanes)


_REF_CASES = [("cp", "tiny_tensor"), ("cp", "tensor4d"), ("cp", "tensor5d"),
              ("tucker", "tiny_tensor"), ("tt", "tiny_tensor")]
_JAX_MAKE = {"cp": jax_make_cp, "tucker": jax_make_tucker, "tt": jax_make_tt}


def _reference_start(fmt, st):
    """The reference drivers' own initial factors (TT: its random cores as
    interface matrices), as numpy arrays."""
    key = jax.random.PRNGKey(0)
    if fmt == "cp":
        return [np.asarray(f) for f in random_factors(key, st.shape, RANKS[fmt])]
    if fmt == "tucker":
        return [np.asarray(f) for f in jax_init_tucker_factors(key, st.shape, RANKS[fmt])]
    return [np.asarray(jax_core_to_matrix(c)) for c in jax_init_tt_cores(key, st.shape, RANKS[fmt])]


def _norm_sq(st) -> float:
    return float(np.sum(st.values.astype(np.float64) ** 2))


@pytest.mark.parametrize("fmt,fixture", _REF_CASES)
def test_restart_history_matches_reference(request, fmt, fixture):
    """Both packages' drive, a NaN injected after iteration 1, policy
    "restart", the same numpy arrays from `reinit`: the restarted fit
    histories agree to 1e-5."""
    st = request.getfixturevalue(fixture)
    start = _reference_start(fmt, st)
    rng = np.random.default_rng(1)
    again = [(f + 1e-3 * np.std(f) * rng.standard_normal(f.shape)).astype(np.float32) for f in start]

    def reinit(attempt):
        return [a.copy() for a in again]

    nxs = _norm_sq(st)
    jax_args = ((jnp.float32(nxs),) if fmt == "tucker" else
                (jnp.asarray(st.indices), jnp.asarray(st.values), jnp.float32(nxs)))
    ref_ws = _JAX_MAKE[fmt](st, RANKS[fmt])
    jax_faults.inject_nan_factor(ref_ws, at_iter=1)
    _, _, ref_fits = ref_ws.drive([jnp.asarray(f) for f in start], jax_args, iters=ITERS,
                                  guards=JaxGuardConfig(policy="restart"), reinit=reinit)
    pst = to_port(st)
    idx, val = tcoo.to_device(pst, CPU)
    args = ((torch.tensor(nxs, dtype=torch.float32),) if fmt == "tucker"
            else (idx, val, torch.tensor(nxs, dtype=torch.float32)))
    ws = MAKE[fmt](pst, RANKS[fmt], device="cpu")
    faults.inject_nan_factor(ws, at_iter=1)
    _, _, fits = ws.drive([torch.tensor(f) for f in start], args, iters=ITERS,
                          guards=GuardConfig(policy="restart"), reinit=reinit)
    assert len(fits) == ITERS and all(math.isfinite(f) for f in fits)
    np.testing.assert_allclose(fits, ref_fits, rtol=0, atol=PARITY_TOL)


@pytest.mark.parametrize("fmt,fixture", _REF_CASES)
def test_fallback_history_matches_reference(request, fmt, fixture):
    """decompose with a NaN injected after iteration 1 and policy
    "fallback", from the reference's initial factors (TT: the TT-SVD init
    both packages take on this tensor): the whole fit history agrees with
    the reference's to 1e-5.  The NaN lands after iteration 1's fit, so the
    guard fires at iteration 2 and the fallback redoes iteration 1 from its
    input: a rebase target that aliased the in-place sweep's factors would
    redo it from iteration 1's output and drift off here."""
    st = request.getfixturevalue(fixture)
    ref_ws = _JAX_MAKE[fmt](st, RANKS[fmt])
    jax_faults.inject_nan_factor(ref_ws, at_iter=1)
    ref = jax_decompose(st, RANKS[fmt], format=fmt, iters=ITERS, seed=0, planned=ref_ws,
                        guards=JaxGuardConfig(policy="fallback"))
    pst = to_port(st)
    ws = MAKE[fmt](pst, RANKS[fmt], device="cpu")
    faults.inject_nan_factor(ws, at_iter=1)
    init = None if fmt == "tt" else _reference_start(fmt, st)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no non-finite fit reaches finish_iter
        out = decompose(pst, RANKS[fmt], format=fmt, iters=ITERS, seed=0, planned=ws,
                        init_factors=init, guards=GuardConfig(policy="fallback"), device="cpu")
    assert len(out.fit_history) == len(ref.fit_history) == ITERS
    np.testing.assert_allclose(out.fit_history, ref.fit_history, rtol=0, atol=PARITY_TOL)


def test_fallback_sweeps_run_no_kernel(tiny, monkeypatch):
    """Every format's fallback sweep runs none of the three kernel
    wrappers."""
    import repro_torch.tt.als as tt_module
    import repro_torch.tucker.hooi as tucker_module

    def refuse(*_a, **_k):
        raise AssertionError("a kernel wrapper ran in a fallback sweep")

    monkeypatch.setattr(ops, "mttkrp_blocked", refuse)
    monkeypatch.setattr(tucker_module, "ttmc_blocked", refuse)
    monkeypatch.setattr(tt_module, "ttcore_blocked", refuse)
    idx, val = tcoo.to_device(tiny, CPU)
    nxs = torch.tensor(tcoo.norm_sq(tiny), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    for fmt in ("cp", "tucker", "tt"):
        ws = MAKE[fmt](tiny, RANKS[fmt], device="cpu")
        facs = ws.pad_factors([torch.randn((s, r), generator=gen) / r
                               for s, r in zip(tiny.shape, ws.lane_ranks)])
        args = (nxs,) if fmt == "tucker" else (idx, val, nxs)
        with pytest.raises(AssertionError, match="kernel wrapper"):
            ws._sweep_call(facs, *args, it=0)
        _, _, fit = ws._fallback_sweep()(facs, *args, it=0)
        assert math.isfinite(float(fit))
