"""The sharded planned path of the port (`method="pallas_sharded"`) against
`repro`, on the CPU, with every shard on `shard_plan(["cpu"] * D)` for D in
1, 2 and 4 at the reference tests' small geometry (tile 16, blocks of 32):

  * each kernel's sharded output (MTTKRP, TTMc, TT-core: one launch per
    shard, then the reduction) against the port's single-device planned
    output, the reference's `*_plan_ref` oracles and, for MTTKRP, the
    reference's own sharded op on its one-device mesh;
  * CP, Tucker and TT fits against `repro.api.decompose(method="pallas")`
    from the reference's initial factors on 3-, 4- and 5-mode tensors (the
    reference holds its own sharded path to that single-device path in its
    multi-device subprocess tests), Tucker factors through their
    projectors, TT models at the non-zeros; one case against the
    reference's `pallas_sharded` on its one-device mesh;
  * `mttkrp_sharded` on both routes, and the API's contracts: placement,
    workspaces, guards (a dead shard, the "fallback" policy), checkpoints
    (`restore(shardings=)`, a resumed sharded run) and calibration."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import decompose as jax_decompose
from repro.core.coo import random_factors, synthetic_tensor
from repro.core.memctrl import CacheEngineConfig as JCache
from repro.core.memctrl import DMAEngineConfig as JDMA
from repro.core.memctrl import MemoryControllerConfig as JCfg
from repro.core.remap import plan_blocks as jax_plan_blocks
from repro.dist.planned import shard_plan as jax_shard_plan
from repro.kernels.ops import make_sharded_planned_mttkrp as jax_make_sharded_mttkrp
from repro.kernels.ref import mttkrp_plan_ref, ttcore_plan_ref, ttmc_plan_ref
from repro.tt import init_tt_cores as jax_init_tt_cores
from repro.tucker import init_tucker_factors as jax_init_tucker_factors
from repro_torch.api import decompose
from repro_torch.convert import cpstate_to_numpy, ttstate_to_numpy, tuckerstate_to_numpy
from repro_torch.core import coo as tcoo
from repro_torch.core.memctrl import CacheEngineConfig, DMAEngineConfig, MemoryControllerConfig
from repro_torch.core.mttkrp import mttkrp_approach1, mttkrp_sharded
from repro_torch.dist import Replicas, ShardingPlan, reduce_partials
from repro_torch.dist.planned import (
    DecompositionDiverged,
    GuardConfig,
    ShardedPlannedCPALS,
    make_sharded_planned_cp_als,
    make_sharded_planned_mttkrp,
    make_sharded_planned_tt,
    make_sharded_planned_tucker,
    shard_plan,
)
from repro_torch.kernels.ops import (
    _stack_call,
    make_planned_cp_als,
    make_planned_mttkrp,
    make_planned_ttcore,
    make_planned_ttmc,
    mttkrp_auto,
)
from repro_torch.kernels.tt import ttcore_blocked
from repro_torch.kernels.ttm import ttmc_blocked
from repro_torch.obs.calibrate import pms_estimates
from repro_torch.testing import faults
from repro_torch.train import CheckpointManager
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL_CFG = MemoryControllerConfig(cache=CacheEngineConfig(tile_i=16, tile_j=16, tile_k=16),
                                   dma=DMAEngineConfig(blk=32))
JAX_SMALL_CFG = JCfg(cache=JCache(tile_i=16, tile_j=16, tile_k=16), dma=JDMA(blk=32))
SHARDS = [1, 2, 4]
ITERS = 2
KERNEL_TOL = 1e-5  # kernel outputs: float32 sums in another order
FIT_TOL = 1e-5  # the ROADMAP's fit bar
PROJ_TOL = 1e-4  # Tucker projectors U U^T
VALUE_TOL = 1e-4  # TT models at the non-zeros, relative to the largest
RANKS = {"cp": 8, "tucker": {3: (3, 4, 3), 4: (3, 2, 3, 2), 5: (2, 2, 3, 2, 2)},
         "tt": {3: (3, 4), 4: (3, 3, 2), 5: (2, 2, 2, 2)}}
FIXTURES = ["tiny_tensor", "tensor4d", "tensor5d"]


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


def cpus(d: int) -> ShardingPlan:
    return shard_plan(["cpu"] * d)


def rank_of(fmt: str, st):
    return RANKS[fmt] if fmt == "cp" else RANKS[fmt][st.nmodes]


def reference_init(fmt: str, st) -> list[np.ndarray]:
    """The reference's own initial factors at seed 0 (TT: init='random')."""
    key, r = jax.random.PRNGKey(0), rank_of(fmt, st)
    if fmt == "cp":
        init = random_factors(key, st.shape, r)
    elif fmt == "tucker":
        init = jax_init_tucker_factors(key, st.shape, r)
    else:
        init = jax_init_tt_cores(key, st.shape, r)
    return [np.asarray(f) for f in init]


_REFERENCE_RUNS: dict = {}


def reference_run(fmt: str, fixture: str, st):
    """repro.api.decompose(method='pallas') at the small geometry, once per
    (format, tensor): every shard count is held to the same run."""
    key = (fmt, fixture)
    if key not in _REFERENCE_RUNS:
        kw = {"init": "random"} if fmt == "tt" else {}
        _REFERENCE_RUNS[key] = jax_decompose(st, rank_of(fmt, st), format=fmt, method="pallas",
                                             iters=ITERS, seed=0, cfg=JAX_SMALL_CFG, **kw)
    return _REFERENCE_RUNS[key]


def sharded_run(fmt: str, st, nshards: int, **kw):
    return decompose(to_port(st), rank_of(fmt, st), format=fmt, method="pallas_sharded",
                     iters=ITERS, init_factors=reference_init(fmt, st), dist=cpus(nshards),
                     cfg=SMALL_CFG, **kw)


def tt_values(cores, indices) -> np.ndarray:
    """The TT model at each non-zero's coordinates, chained in float64."""
    v = np.ones((indices.shape[0], 1))
    for k, c in enumerate(cores):
        v = np.einsum("za,zab->zb", v, np.asarray(c, np.float64).transpose(1, 0, 2)[indices[:, k]])
    return v[:, 0]


def random_mats(shape, widths, seed: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((s, w)).astype(np.float32)) for s, w in zip(shape, widths)]


def padded_np(f: torch.Tensor, rows: int) -> jnp.ndarray:
    out = np.zeros((rows, f.shape[1]), np.float32)
    out[: f.shape[0]] = f.numpy()
    return jnp.asarray(out)


def ref_plan(st, mode: int):
    return jax_plan_blocks(st, mode, tile_i=16, blk=32, in_tiles=(16,) * (st.nmodes - 1))


# ---------------------------------------------------------------------------
# each kernel, sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nshards", SHARDS)
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d"])
def test_sharded_mttkrp_matches_single_device_and_reference(request, fixture, nshards):
    ref_st = request.getfixturevalue(fixture)
    st = to_port(ref_st)
    facs = random_mats(st.shape, [8] * st.nmodes, seed=1)
    for m in range(st.nmodes):
        got = make_sharded_planned_mttkrp(st, m, 8, dist=cpus(nshards), cfg=SMALL_CFG).output(
            facs, st.shape[m])
        single = make_planned_mttkrp(st, m, 8, cfg=SMALL_CFG, device="cpu").output(facs, st.shape[m])
        plan = ref_plan(ref_st, m)
        oracle = mttkrp_plan_ref(plan, [padded_np(facs[im], r) for im, r in
                                        zip(plan.in_modes, plan.in_rows)], 8)
        assert got.shape == (st.shape[m], 8)
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=KERNEL_TOL, atol=KERNEL_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle)[: st.shape[m]], rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)


def test_sharded_mttkrp_matches_reference_sharded_op(tiny_tensor):
    """The reference's own `make_sharded_planned_mttkrp` on its one-device
    mesh (interpret mode), mode 0."""
    facs = random_mats(tiny_tensor.shape, [8] * 3, seed=2)
    want = jax_make_sharded_mttkrp(tiny_tensor, 0, 8, dist=jax_shard_plan(1), cfg=JAX_SMALL_CFG)
    want = np.asarray(want.output([jnp.asarray(f.numpy()) for f in facs], tiny_tensor.shape[0]))
    for nshards in SHARDS:
        got = make_sharded_planned_mttkrp(to_port(tiny_tensor), 0, 8, dist=cpus(nshards),
                                          cfg=SMALL_CFG).output(facs, tiny_tensor.shape[0])
        np.testing.assert_allclose(got.numpy(), want, rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("nshards", SHARDS)
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor5d"])
def test_sharded_ttmc_matches_single_device_and_reference(request, fixture, nshards):
    ref_st = request.getfixturevalue(fixture)
    st = to_port(ref_st)
    cr = rank_of("tucker", st)
    ws = make_sharded_planned_tucker(st, cr, dist=cpus(nshards), cfg=SMALL_CFG)
    facs = random_mats(st.shape, cr, seed=3)
    reps = Replicas(ws.pad_factors(facs), ws.dist.devices)
    for m in range(st.nmodes):
        in_ranks = ws.in_ranks(m)
        ncols = math.prod(in_ranks)
        got = reduce_partials(_stack_call(ws.stacks[m], ttmc_blocked, reps, in_ranks))
        got = got[: st.shape[m], :ncols]
        single = make_planned_ttmc(st, m, cr, cfg=SMALL_CFG, device="cpu").output(facs, st.shape[m])
        plan = ref_plan(ref_st, m)
        oracle = ttmc_plan_ref(plan, [padded_np(facs[im], r) for im, r in
                                      zip(plan.in_modes, plan.in_rows)], in_ranks)
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=KERNEL_TOL, atol=KERNEL_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle)[: st.shape[m]], rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)


@pytest.mark.parametrize("nshards", SHARDS)
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d"])
def test_sharded_ttcore_matches_single_device_and_reference(request, fixture, nshards):
    ref_st = request.getfixturevalue(fixture)
    st = to_port(ref_st)
    tr = rank_of("tt", st)
    ws = make_sharded_planned_tt(st, tr, dist=cpus(nshards), cfg=SMALL_CFG)
    mats = random_mats(st.shape, ws.lane_ranks, seed=4)
    reps = Replicas(ws.pad_factors(mats), ws.dist.devices)
    for m in range(st.nmodes):
        pairs = ws.in_rank_pairs(m)
        got = reduce_partials(_stack_call(ws.stacks[m], ttcore_blocked, reps, pairs, m))
        got = got[: st.shape[m], : ws.lane_ranks[m]]
        single = make_planned_ttcore(st, m, tr, cfg=SMALL_CFG, device="cpu").output(mats, st.shape[m])
        plan = ref_plan(ref_st, m)
        oracle = ttcore_plan_ref(plan, [padded_np(mats[im], r) for im, r in
                                        zip(plan.in_modes, plan.in_rows)], pairs, m)
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=KERNEL_TOL, atol=KERNEL_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle)[: st.shape[m], : ws.lane_ranks[m]],
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)


def test_empty_intra_range_tiles_are_zero_not_nan():
    """A tile with no non-zero inside a shard's range is visited by no block:
    the sharded output is exactly zero there (the wrappers' zeroed output,
    where the reference needs its row mask), and the whole decomposition
    matches the single-device path."""
    st0 = synthetic_tensor((64, 48, 80), 3000, seed=5, skew=0.5)
    keep = (st0.indices[:, 0] < 16) | (st0.indices[:, 0] >= 24)
    st = tcoo.SparseTensor(st0.indices[keep], st0.values[keep], st0.shape)  # tile 2 empty
    cfg = MemoryControllerConfig(cache=CacheEngineConfig(tile_i=8, tile_j=16, tile_k=16),
                                 dma=DMAEngineConfig(blk=32))
    facs = random_mats(st.shape, [8] * 3, seed=0)
    want = mttkrp_approach1(torch.from_numpy(st.indices).long(), torch.from_numpy(st.values), facs,
                            0, st.shape[0], sorted_by_mode=False)
    for nshards in (2, 4):
        got = make_sharded_planned_mttkrp(st, 0, 8, dist=cpus(nshards), cfg=cfg).output(facs, 64)
        assert bool(torch.isfinite(got).all()) and bool((got[16:24] == 0).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
        s_sh = decompose(st, 8, iters=2, method="pallas_sharded", dist=cpus(nshards), cfg=cfg)
        s_ref = decompose(st, 8, iters=2, cfg=cfg, device="cpu")
        np.testing.assert_allclose(s_sh.fit_history, s_ref.fit_history, rtol=0, atol=FIT_TOL)


# ---------------------------------------------------------------------------
# the slice as a whole: fits against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nshards", SHARDS)
@pytest.mark.parametrize("fixture", FIXTURES)
def test_cp_matches_reference(request, fixture, nshards):
    st = request.getfixturevalue(fixture)
    ref = reference_run("cp", fixture, st)
    out = cpstate_to_numpy(sharded_run("cp", st, nshards))
    assert len(out["fit_history"]) == ITERS
    np.testing.assert_allclose(out["fit_history"], ref.fit_history, rtol=0, atol=FIT_TOL)
    for got, want in zip(out["factors"], ref.factors):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=PROJ_TOL)


@pytest.mark.parametrize("nshards", SHARDS)
@pytest.mark.parametrize("fixture", FIXTURES)
def test_tucker_matches_reference(request, fixture, nshards):
    st = request.getfixturevalue(fixture)
    ref = reference_run("tucker", fixture, st)
    out = tuckerstate_to_numpy(sharded_run("tucker", st, nshards))
    np.testing.assert_allclose(out["fit_history"], ref.fit_history, rtol=0, atol=FIT_TOL)
    assert out["core"].shape == tuple(rank_of("tucker", st))
    for u, w in zip(out["factors"], ref.factors):
        u, w = u.astype(np.float64), np.asarray(w, np.float64)
        np.testing.assert_allclose(u @ u.T, w @ w.T, rtol=0, atol=PROJ_TOL)


@pytest.mark.parametrize("nshards", SHARDS)
@pytest.mark.parametrize("fixture", FIXTURES)
def test_tt_matches_reference(request, fixture, nshards):
    st = request.getfixturevalue(fixture)
    ref = reference_run("tt", fixture, st)
    out = ttstate_to_numpy(sharded_run("tt", st, nshards))
    np.testing.assert_allclose(out["fit_history"], ref.fit_history, rtol=0, atol=FIT_TOL)
    got, want = tt_values(out["cores"], st.indices), tt_values(ref.cores, st.indices)
    assert np.abs(got - want).max() <= VALUE_TOL * np.abs(want).max()


def test_tucker_matches_reference_sharded_path(tiny_tensor):
    """The reference's own `pallas_sharded` on its one-device mesh."""
    cr = rank_of("tucker", tiny_tensor)
    ref = jax_decompose(tiny_tensor, cr, format="tucker", method="pallas_sharded", devices=1,
                        iters=ITERS, seed=0, cfg=JAX_SMALL_CFG)
    for nshards in SHARDS:
        out = tuckerstate_to_numpy(sharded_run("tucker", tiny_tensor, nshards))
        np.testing.assert_allclose(out["fit_history"], ref.fit_history, rtol=0, atol=FIT_TOL)
        np.testing.assert_allclose(np.abs(out["core"]), np.abs(np.asarray(ref.core)), rtol=0,
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# mttkrp_sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nshards", SHARDS)
def test_mttkrp_sharded_routes(tiny_tensor, nshards):
    """Both approaches over contiguous pieces of a sorted stream, and the
    planned route, against one device's MTTKRP on every mode."""
    st = to_port(tiny_tensor)
    facs = random_mats(st.shape, [16] * 3, seed=5)
    for m in range(3):
        s = st.sorted_by(m)
        idx, val = torch.from_numpy(s.indices).long(), torch.from_numpy(s.values)
        want = mttkrp_approach1(idx, val, facs, m, st.shape[m])
        for method in ("approach1", "approach2"):
            fn = mttkrp_sharded(cpus(nshards), m, st.shape[m], method=method, sorted_by_mode=True)
            np.testing.assert_allclose(fn(idx, val, facs).numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
        fn = mttkrp_sharded(cpus(nshards), m, st.shape[m], method="pallas", st=st, rank=16,
                            cfg=SMALL_CFG)
        got = fn(None, None, facs)
        np.testing.assert_allclose(got.numpy(), mttkrp_auto(st, facs, m, cfg=SMALL_CFG,
                                                            device="cpu").numpy(),
                                   rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="st="):
        mttkrp_sharded(cpus(1), 0, st.shape[0], method="pallas")
    with pytest.raises(ValueError, match="unknown method"):
        mttkrp_sharded(cpus(1), 0, st.shape[0], method="approach3")


# ---------------------------------------------------------------------------
# API contracts
# ---------------------------------------------------------------------------


def test_shard_plan_contracts(monkeypatch):
    plan = shard_plan(["cpu"] * 3)
    assert plan.dp_size() == 3 and plan.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="devices"):
        shard_plan(0)
    with pytest.raises(ValueError, match=r"shard_plan\(\['cuda:0'\] \* 4\)"):
        shard_plan(4096)
    with pytest.raises(ValueError, match="at least one"):
        shard_plan([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: shard_plan(), lambda: shard_plan(1), lambda: shard_plan(["cuda:0"]),
                 lambda: decompose(to_port(synthetic_tensor((8, 8, 8), 64, seed=0)), 2,
                                   method="pallas_sharded", devices=1)):
        with pytest.raises(ValueError, match="CUDA devices"):
            call()


def test_sharded_api_contracts(tiny_tensor):
    st = to_port(tiny_tensor)
    for method in ("pallas", "approach1"):
        with pytest.raises(ValueError, match="silently ignored"):
            decompose(st, 4, iters=1, dist=cpus(2), method=method)
    with pytest.raises(ValueError, match="device= and devices="):
        decompose(st, 4, iters=1, dist=cpus(2), method="pallas_sharded", device="cpu")
    with pytest.raises(ValueError, match="hbm_budget"):
        decompose(st, 4, iters=1, dist=cpus(2), method="pallas_sharded", hbm_budget=1 << 30)
    with pytest.raises(ValueError, match="ShardedPlannedCPALS"):
        decompose(st, 4, iters=1, method="pallas_sharded",
                  planned=make_planned_cp_als(st, 4, cfg=SMALL_CFG, device="cpu"))
    ws = make_sharded_planned_cp_als(st, 4, dist=cpus(2), cfg=SMALL_CFG)
    with pytest.raises(ValueError, match="pallas_sharded"):
        decompose(st, 4, iters=1, planned=ws, device="cpu")
    with pytest.raises(ValueError, match="ShardedPlannedTucker"):
        decompose(st, (4, 4, 4), format="tucker", iters=1, method="pallas_sharded", planned=ws)
    with pytest.raises(ValueError, match="does not match"):
        decompose(st, 5, iters=1, method="pallas_sharded", planned=ws)
    with pytest.raises(ValueError, match="spans 2 shards"):
        decompose(st, 4, iters=1, method="pallas_sharded", planned=ws, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="disagree"):
        make_sharded_planned_cp_als(st, 4, dist=cpus(2), devices=4)
    with pytest.raises(ValueError, match="mttkrp_fn"):
        decompose(st, 4, iters=1, method="pallas_sharded", dist=cpus(2),
                  mttkrp_fn=lambda *a: None)
    # a prebuilt workspace is reused: the same fits as a fresh build
    a = decompose(st, 4, iters=2, method="pallas_sharded", planned=ws, devices=["cpu", "cpu"])
    b = decompose(st, 4, iters=2, method="pallas_sharded", dist=cpus(2), cfg=SMALL_CFG)
    assert a.fit_history == b.fit_history
    assert ws.nshards == 2 and ws.device == torch.device("cpu")
    with pytest.raises(TypeError, match="single-device"):
        pms_estimates(ws)


def test_dead_shard_detected_by_regression_guard(tiny_tensor):
    """A shard whose values die after iteration 1 drops its part of every
    reduced output; the fit falls and the regression guard raises."""
    st = to_port(tiny_tensor)
    ws = faults.deaden_shard(make_sharded_planned_cp_als(st, 8, dist=cpus(2)), shard=0, at_iter=1)
    cached = ws.stacks[0].plans[0].vals.clone()
    with pytest.raises(DecompositionDiverged, match="regressed"):
        decompose(st, 8, iters=10, seed=0, method="pallas_sharded", planned=ws,
                  guards=GuardConfig(policy="raise", divergence_patience=2))
    assert float(ws.stacks[0].plans[0].vals.abs().sum()) == 0.0
    fresh = make_sharded_planned_cp_als(st, 8, dist=cpus(2))  # the plan cache's plans live on
    assert torch.equal(fresh.stacks[0].plans[0].vals, cached)
    with pytest.raises(ValueError, match="sharded workspace"):
        faults.deaden_shard(make_planned_cp_als(st, 8, device="cpu"), shard=0, at_iter=1)


def test_fallback_policy_escalates(tiny_tensor):
    """No reference sweep runs over shard stacks: "fallback" raises."""
    st = to_port(tiny_tensor)
    ws = faults.inject_nan_factor(make_sharded_planned_cp_als(st, 8, dist=cpus(2)), at_iter=1)
    with pytest.raises(DecompositionDiverged, match="no reference fallback sweep"):
        decompose(st, 8, iters=4, seed=0, method="pallas_sharded", planned=ws,
                  guards=GuardConfig(policy="fallback"))
    ws = faults.inject_nan_factor(make_sharded_planned_tt(st, (3, 4), dist=cpus(4)), at_iter=1)
    with pytest.raises(DecompositionDiverged):
        decompose(st, (3, 4), format="tt", iters=4, method="pallas_sharded", planned=ws,
                  init="random", guards=GuardConfig(policy="fallback"))


def test_restore_with_shardings(tmp_path):
    """The elastic restore: a tree of devices of the saved tree's structure
    puts each leaf on its device."""
    tree = {"facs": (torch.arange(6.0).reshape(2, 3), torch.ones(4)), "fits": np.arange(3.0),
            "step": 7}
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(3, tree)
    step, got = mgr.restore(shardings={"facs": ("cpu", torch.device("cpu")), "fits": "cpu",
                                       "step": "cpu"})
    assert step == 3
    assert torch.equal(got["facs"][0], tree["facs"][0]) and torch.equal(got["facs"][1], tree["facs"][1])
    assert got["fits"].tolist() == [0.0, 1.0, 2.0] and int(got["step"]) == 7
    assert all(t.device == torch.device("cpu") for t in (*got["facs"], got["fits"], got["step"]))
    with pytest.raises(ValueError, match="structure"):
        mgr.restore(shardings={"facs": ("cpu",), "fits": "cpu", "step": "cpu"})
    with pytest.raises(ValueError, match="not both"):
        mgr.restore(device="cpu", shardings={"facs": ("cpu", "cpu"), "fits": "cpu", "step": "cpu"})


@pytest.mark.parametrize("fmt", ["cp", "tt"])
def test_sharded_run_resumes_from_checkpoint(tiny_tensor, tmp_path, fmt):
    """A sharded run checkpointed at iteration 2 and resumed to 4 gives the
    uninterrupted run's fits (the CPU paths are deterministic)."""
    st = to_port(tiny_tensor)
    r = rank_of(fmt, st)
    kw = dict(format=fmt, method="pallas_sharded", dist=cpus(2), cfg=SMALL_CFG, seed=0,
              **({"init": "random"} if fmt == "tt" else {}))
    clean = decompose(st, r, iters=4, **kw).fit_history
    decompose(st, r, iters=2, checkpoint_path=tmp_path / fmt, **kw)
    resumed = decompose(st, r, iters=4, checkpoint_path=tmp_path / fmt, **kw).fit_history
    np.testing.assert_allclose(resumed, clean, rtol=0, atol=1e-6)


def test_layout_is_counted_per_shard_and_shared_by_formats(tiny_tensor):
    """The shards' plans hold the same slots as one device's, plus each
    shard's own padding; CP and Tucker workspaces on one tensor and config
    share the plan objects (the plan cache's layout keys)."""
    st = to_port(tiny_tensor)
    one = make_planned_cp_als(st, 4, cfg=SMALL_CFG, device="cpu").plan_bytes()
    for nshards in SHARDS:
        cp = make_sharded_planned_cp_als(st, 4, dist=cpus(nshards), cfg=SMALL_CFG)
        tk = make_sharded_planned_tucker(st, (2, 2, 2), dist=cpus(nshards), cfg=SMALL_CFG)
        assert isinstance(cp, ShardedPlannedCPALS)
        assert cp.plan_bytes() == tk.plan_bytes() >= one
        assert all(a is b for m in range(3)
                   for a, b in zip(cp.stacks[m].plans, tk.stacks[m].plans) if a.nnz)
        if nshards == 1:
            assert cp.plan_bytes() == one
