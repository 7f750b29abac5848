"""The port's distribution layer against `repro.dist`, on the CPU: the
stream partitioner bit for bit, each shard's plan bit for bit (empty shards
included), the shards' makespan report, the sharded PMS, the plan cache's
shard-aware keys and the autotune cache's shard count.  Every sharded
workspace here runs its shards on `shard_plan(["cpu"] * D)`, at the
reference tests' small geometry (tile 16, blocks of 32)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as hst

from repro.core.coo import synthetic_tensor
from repro.core.memctrl import CacheEngineConfig as JCache
from repro.core.memctrl import DMAEngineConfig as JDMA
from repro.core.memctrl import MemoryControllerConfig as JCfg
from repro.core.remap import plan_blocks as jax_plan_blocks
from repro.dist.planned import shard_makespan_report as jax_makespan_report
from repro.dist.planned import shard_plan as jax_shard_plan
from repro.dist.sharding import partition_stream as jax_partition_stream
from repro.kernels.ops import _empty_shard_plan as jax_empty_shard_plan
from repro.kernels.ops import make_sharded_planned_cp_als as jax_make_sharded_cp
from repro_torch.core import coo as tcoo
from repro_torch.core.memctrl import CacheEngineConfig, DMAEngineConfig, GPUSpec, MemoryControllerConfig
from repro_torch.core.pms import predict_sharded, search_sharded
from repro_torch.dist import ShardingPlan, partition_stream, stream_imbalance
from repro_torch.dist.planned import (
    make_sharded_planned_cp_als,
    make_sharded_planned_mttkrp,
    make_sharded_planned_tt,
    make_sharded_planned_tucker,
    shard_makespan_report,
    shard_plan,
)
from repro_torch.kernels import ops
from repro_torch.kernels.workspace import sharded_layout_bytes
from repro_torch.obs import metrics
from repro_torch.tune.cache import config_key
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SMALL_CFG = MemoryControllerConfig(cache=CacheEngineConfig(tile_i=16, tile_j=16, tile_k=16),
                                   dma=DMAEngineConfig(blk=32))
JAX_SMALL_CFG = JCfg(cache=JCache(tile_i=16, tile_j=16, tile_k=16), dma=JDMA(blk=32))


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


def cpus(d: int) -> ShardingPlan:
    return shard_plan(["cpu"] * d)


def assert_plans_equal(ref, plan):
    """Every BlockPlan field equal, arrays bit for bit and of the same dtype."""
    for name in ("vals", "iloc", "block_it"):
        a, b = np.asarray(getattr(ref, name)), getattr(plan, name).cpu().numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("in_locs", "block_in"):
        xs, ys = getattr(ref, name), getattr(plan, name)
        assert len(xs) == len(ys), name
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(np.asarray(x), y.cpu().numpy(), err_msg=name)
            assert np.asarray(x).dtype == y.cpu().numpy().dtype, name
    for name in ("tile_i", "in_tiles", "blk", "out_rows", "in_rows", "mode", "in_modes", "nnz"):
        assert getattr(ref, name) == getattr(plan, name), name


# ---------------------------------------------------------------------------
# the partitioner
# ---------------------------------------------------------------------------


@settings(max_examples=20, deadline=None)
@given(
    dims=hst.tuples(hst.integers(4, 70), hst.integers(4, 70), hst.integers(4, 70)),
    nnz=hst.integers(1, 1_500),
    nshards=hst.integers(1, 6),
    tile=hst.sampled_from([1, 7, 16, 64]),
    mode=hst.integers(0, 2),
    seed=hst.integers(0, 99),
)
def test_partition_matches_reference(dims, nnz, nshards, tile, mode, seed):
    """The reference's cut points, shards and positions to the bit, and its
    invariants: a disjoint cover that reassembles the exact stream,
    tile-aligned ranges, the original order within a shard."""
    ref_st = synthetic_tensor(dims, nnz, seed=seed, skew=0.7)
    st = to_port(ref_st)
    ref = jax_partition_stream(ref_st, mode, nshards, tile=tile)
    part = partition_stream(st, mode, nshards, tile=tile)
    assert part.tile_bounds == ref.tile_bounds
    assert part.shard_nnz == ref.shard_nnz and part.nshards == nshards
    assert part.row_ranges() == ref.row_ranges()
    assert part.imbalance() == ref.imbalance()
    for sh, rsh, pos, rpos in zip(part.shards, ref.shards, part.positions, ref.positions):
        np.testing.assert_array_equal(sh.indices, rsh.indices)
        np.testing.assert_array_equal(sh.values, rsh.values)
        np.testing.assert_array_equal(pos, rpos)
        assert sh.shape == st.shape
    re = part.reassemble()
    np.testing.assert_array_equal(re.indices, st.indices)
    np.testing.assert_array_equal(re.values, st.values)
    for (a, b), sh, pos in zip(part.row_ranges(), part.shards, part.positions):
        assert a % tile == 0 or a == st.shape[mode]
        if sh.nnz:
            c = sh.indices[:, mode]
            assert a <= c.min() and c.max() < b
            assert np.all(np.diff(pos) > 0)


@settings(max_examples=10, deadline=None)
@given(nnz=hst.integers(64, 2_000), nshards=hst.sampled_from([2, 4]), seed=hst.integers(0, 20))
def test_partition_balances_when_tiles_allow(nnz, nshards, seed):
    st = to_port(synthetic_tensor((256, 64, 64), nnz, seed=seed, skew=0.3))
    assert partition_stream(st, 0, nshards, tile=4).imbalance() < 2.0


def test_partition_validates_arguments():
    st = to_port(synthetic_tensor((8, 8, 8), 64, seed=0))
    with pytest.raises(ValueError, match="nshards"):
        partition_stream(st, 0, 0)
    with pytest.raises(ValueError, match="mode"):
        partition_stream(st, 3, 2)
    with pytest.raises(ValueError, match="tile"):
        partition_stream(st, 0, 2, tile=0)


def test_partition_more_shards_than_tiles():
    """One tile, five shards: four empty, the cover still exact, as the
    reference's."""
    ref_st = synthetic_tensor((8, 8, 8), 100, seed=1)
    part = partition_stream(to_port(ref_st), 0, 5, tile=8)
    assert part.tile_bounds == jax_partition_stream(ref_st, 0, 5, tile=8).tile_bounds
    assert sum(part.shard_nnz) == ref_st.nnz
    assert sum(1 for n in part.shard_nnz if n == 0) >= 4
    np.testing.assert_array_equal(part.reassemble().indices, ref_st.indices)
    assert stream_imbalance((0, 0)) == 1.0 and stream_imbalance(part.shard_nnz) == 5.0


# ---------------------------------------------------------------------------
# the shards' plans and the makespan report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nshards", [1, 2, 4])
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_shard_plans_match_reference(request, fixture, nshards):
    """Each shard's plan is `repro.core.remap.plan_blocks` on the
    reference's shard, bit for bit, on its device; the layouts' bytes are
    those of the shards' plans (unpadded)."""
    ref_st = request.getfixturevalue(fixture)
    ws = make_sharded_planned_cp_als(to_port(ref_st), 4, dist=cpus(nshards), cfg=SMALL_CFG)
    for m in range(ref_st.nmodes):
        stack = ws.stacks[m]
        ref = jax_partition_stream(ref_st, m, nshards, tile=16)
        assert stack.tile_bounds == ref.tile_bounds
        assert stack.nshards == nshards and all(p.device == ws.device for p in stack.plans)
        for shard, plan in zip(ref.shards, stack.plans):
            if shard.nnz == 0:
                want = jax_empty_shard_plan(ref_st.shape, m, JAX_SMALL_CFG)
            else:
                want = jax_plan_blocks(shard, m, tile_i=16, blk=32,
                                       in_tiles=JAX_SMALL_CFG.cache.input_tiles(ref_st.nmodes - 1))
            assert_plans_equal(want, plan)
    r = SMALL_CFG.remapper
    want = sum(p.vals.shape[0] * (r.value_bytes + ref_st.nmodes * r.index_bytes)
               + p.nblocks * ref_st.nmodes * r.index_bytes
               for s in ws.stacks.values() for p in s.plans)
    assert ws.plan_bytes() == sharded_layout_bytes(ws.stacks, ws.cfgs) == want


@pytest.mark.parametrize("kind", ["cp", "tucker", "tt"])
def test_empty_shards_take_the_reference_empty_plan(kind):
    """More shards than output tiles: the empty shards' plans equal the
    reference's `_empty_shard_plan`, for every format's workspace."""
    ref_st = synthetic_tensor((12, 30, 20), 300, seed=4, skew=0.5)
    st = to_port(ref_st)
    make = {"cp": lambda: make_sharded_planned_cp_als(st, 4, dist=cpus(4), cfg=SMALL_CFG),
            "tucker": lambda: make_sharded_planned_tucker(st, (2, 3, 2), dist=cpus(4), cfg=SMALL_CFG),
            "tt": lambda: make_sharded_planned_tt(st, (2, 3), dist=cpus(4), cfg=SMALL_CFG)}[kind]
    ws = make()
    stack = ws.stacks[0]  # 12 rows: one tile of 16
    assert stack.shard_nnz[1:] == (0, 0, 0) and stack.shard_nnz[0] == st.nnz
    for plan in stack.plans[1:]:
        assert_plans_equal(jax_empty_shard_plan(st.shape, 0, JAX_SMALL_CFG), plan)


@pytest.mark.parametrize("nshards", [1, 2, 4])
def test_makespan_report_matches_reference(tiny_tensor, nshards):
    """The reference's report on the reference's own shard plans (its
    sharded workspace where this process has the devices: one), number for
    number, and the metrics it records."""
    metrics.reset()
    ws = make_sharded_planned_cp_als(to_port(tiny_tensor), 8, dist=cpus(nshards), cfg=SMALL_CFG)
    got = shard_makespan_report(ws)
    if nshards == 1:
        want = jax_makespan_report(jax_make_sharded_cp(tiny_tensor, 8, dist=jax_shard_plan(1),
                                                       cfg=JAX_SMALL_CFG))
    else:
        class Stack:
            def __init__(self, m):
                part = jax_partition_stream(tiny_tensor, m, nshards, tile=16)
                plans = [jax_plan_blocks(sh, m, tile_i=16, blk=32, in_tiles=(16, 16))
                         if sh.nnz else jax_empty_shard_plan(tiny_tensor.shape, m, JAX_SMALL_CFG)
                         for sh in part.shards]
                self.mode = m
                self.shard_nblocks = tuple(p.nblocks for p in plans)
                self.shard_nnz = tuple(p.nnz for p in plans)

        want = jax_makespan_report(type("WS", (), {"stacks": {m: Stack(m) for m in range(3)}})())
    assert got == want
    assert metrics.snapshot()["histograms"]["sharded.block_imbalance{mode=0}"]["count"] == 1
    assert metrics.snapshot()["histograms"]["sharded.block_imbalance{kind=mttkrp}"]["count"] == 3
    op = make_sharded_planned_mttkrp(to_port(tiny_tensor), 1, 8, dist=cpus(nshards), cfg=SMALL_CFG)
    assert shard_makespan_report(op)["modes"][1] == got["modes"][1]
    with pytest.raises(TypeError, match="shard stacks"):
        shard_makespan_report(object())


# ---------------------------------------------------------------------------
# the sharded PMS
# ---------------------------------------------------------------------------


def test_predict_sharded_is_the_makespan(small_tensor):
    st = to_port(small_tensor)
    est = predict_sharded(st, 0, 16, 4, MemoryControllerConfig(), device="cpu")
    assert est.nshards == 4
    assert est.t_total == max(e.t_total for e in est.per_shard)
    assert est.t_sum == pytest.approx(sum(e.t_total for e in est.per_shard))
    assert est.per_shard[est.critical_shard].t_total == est.t_total
    assert est.imbalance >= 1.0 and est.smem_bytes == est.per_shard[0].smem_bytes
    assert est.shard_nnz == jax_partition_stream(small_tensor, 0, 4, tile=256).shard_nnz
    assert est.bottleneck == est.per_shard[est.critical_shard].bottleneck
    # the analytic prices agree on which shard is the busiest
    est_a = predict_sharded(st, 0, 16, 4, MemoryControllerConfig(), exact=False)
    assert est_a.shard_nnz == est.shard_nnz


def test_search_sharded_ranks_by_worst_shard(small_tensor):
    st = to_port(small_tensor)
    metrics.reset()
    best = search_sharded(st, 0, 16, 2, top_k=4)
    assert len(best) == 4
    makespans = [e.t_total for e in best]
    assert makespans == sorted(makespans)
    snap = metrics.snapshot()["counters"]
    assert snap["pms.searches{kernel=mttkrp,sharded=true}"] == 1
    assert snap["pms.configs_evaluated{kernel=mttkrp,sharded=true}"] >= 4
    with pytest.raises(ValueError, match="core_ranks"):
        search_sharded(st, 0, 16, 2, kernel="ttmc")
    bt = search_sharded(st, 0, 16, 2, kernel="ttmc", core_ranks=(8, 8, 8), top_k=2)
    assert bt and bt[0].t_total <= bt[-1].t_total
    tt = search_sharded(st, 1, 0, 4, kernel="tt", core_ranks=(4, 4), top_k=2)
    assert tt and all(e.nshards == 4 for e in tt)


def test_predict_sharded_handles_empty_shards():
    st = to_port(synthetic_tensor((8, 8, 8), 50, seed=0))
    est = predict_sharded(st, 0, 8, 4, MemoryControllerConfig(), device="cpu")  # 1 tile, 4 shards
    assert est.t_total > 0.0
    assert sum(1 for e in est.per_shard if e.t_total == 0.0) >= 3
    assert est.critical_shard == 0


# ---------------------------------------------------------------------------
# the plan cache and the autotune cache
# ---------------------------------------------------------------------------


def test_shard_plans_cached_under_shard_keys(tiny_tensor):
    """The reference's `test_sharded_mttkrp_route_and_cache_keys`: a rebuild
    hits the shard-keyed entries, at another rank too (they are raw plans),
    and a Tucker workspace of the same tensor and config reuses the CP
    build's shard layouts (counted under its own kind)."""
    st = to_port(tiny_tensor)
    ops.plan_cache_clear()
    try:
        make_sharded_planned_mttkrp(st, 0, 8, dist=cpus(2), cfg=SMALL_CFG)
        s1 = ops.plan_cache_stats()["by_kind"]["mttkrp"]
        assert s1 == {"hits": 0, "misses": 2}
        make_sharded_planned_mttkrp(st, 0, 8, dist=cpus(2), cfg=SMALL_CFG)
        make_sharded_planned_mttkrp(st, 0, 4, dist=cpus(2), cfg=SMALL_CFG)
        assert ops.plan_cache_stats()["by_kind"]["mttkrp"] == {"hits": 4, "misses": 2}
        make_sharded_planned_tucker(st, (4, 4, 4), dist=cpus(2), cfg=SMALL_CFG)
        assert ops.plan_cache_stats()["by_kind"]["ttmc"] == {"hits": 2, "misses": 4}
        # another shard count is another layout
        make_sharded_planned_mttkrp(st, 0, 8, dist=cpus(4), cfg=SMALL_CFG)
        assert ops.plan_cache_stats()["by_kind"]["mttkrp"]["misses"] == 6
        assert all(k[0] in ("layout",) and k[-1] is not None for k in ops._PLAN_CACHE)
    finally:
        ops.plan_cache_clear()


def test_autotune_cache_keys_the_shard_count(tiny_tensor, tmp_path, monkeypatch):
    """auto_tune="cached" on the sharded path keeps its picks under the
    shard count: a 2-shard winner is not served to 4 shards or to one
    device."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path / "autotune"))
    st = to_port(tiny_tensor)
    spec = GPUSpec()
    keys = {config_key("mttkrp", st.fingerprint(), 0, 8, backend="cpu", spec=spec, nshards=n)
            for n in (None, 1, 2, 4)}
    assert len(keys) == 4
    metrics.reset()
    ws = make_sharded_planned_cp_als(st, 8, dist=cpus(2), auto_tune="cached")
    again = make_sharded_planned_cp_als(st, 8, dist=cpus(2), auto_tune="cached")
    snap = metrics.snapshot()["counters"]
    assert snap["autotune_cache.misses{kind=mttkrp}"] == 3
    assert snap["autotune_cache.hits{kind=mttkrp}"] == 3
    assert again.cfgs == ws.cfgs
    assert ws.cfgs[0] == search_sharded(st, 0, 8, 2, top_k=1)[0].cfg
    make_sharded_planned_cp_als(st, 8, dist=cpus(4), auto_tune="cached")
    assert metrics.snapshot()["counters"]["autotune_cache.misses{kind=mttkrp}"] == 6


def test_distribution_imports_no_jax():
    code = ("import sys, repro_torch.dist, repro_torch.dist.planned, repro_torch.dist.collective; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
