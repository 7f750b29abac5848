"""The port's PMS (`repro_torch.core.pms`) and its inputs against the
reference's (`repro.core.pms`, `repro.core.hypergraph`) on the same numpy
tensors: what depends only on the layout is equal to the bit (hypergraph
statistics, traffic models, fingerprints, tile fills, nblocks, padding and
the stream term, for every candidate of the default grid); the terms that
differ on purpose (lane padding, the CUDA kernels' own flops, shared memory
per CTA, the re-reads of row parts and column slices, occupancy and the
TT-core kernel's busy share) are held to closed forms written here from the
kernels' layouts."""
import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from repro.core import hypergraph as jhg
from repro.core import pms as jpms
from repro.core.memctrl import CacheEngineConfig as JCache
from repro.core.memctrl import DMAEngineConfig as JDMA
from repro.core.memctrl import MemoryControllerConfig as JConfig
from repro.core.memctrl import TPUSpec
from repro.core.remap import plan_blocks as jplan_blocks
from repro_torch.core import coo as tcoo
from repro_torch.core import hypergraph as thg
from repro_torch.core import pms
from repro_torch.core.memctrl import (
    CacheEngineConfig,
    DMAEngineConfig,
    GPUSpec,
    MemoryControllerConfig,
)
from repro_torch.core.remap import plan_blocks
from repro_torch.kernels.mttkrp import rank_padded
from repro_torch.kernels.ops import make_planned_cp_als, make_planned_mttkrp
from repro_torch.obs import metrics
from repro_torch.tt import make_planned_tt
from repro_torch.tucker import make_planned_tucker

FIXTURES = ["tiny_tensor", "tensor4d", "tensor5d"]
SPEC = GPUSpec()
# The reference's spec at the same memory rate, with a VMEM budget that
# prunes no candidate of the grid.
BIG_TPU = TPUSpec(hbm_bw=SPEC.hbm_bw, vmem_bytes=1 << 60)
GRID = list(itertools.product(pms.DEFAULT_TILE_CHOICES, pms.DEFAULT_TILE_CHOICES,
                              pms.DEFAULT_TILE_CHOICES, pms.DEFAULT_BLK_CHOICES))
# The exact search builds a plan per candidate: the default grid, and
# small tiles and blocks that split the test tensors into many groups.
EXACT_GRIDS = {"default": (pms.DEFAULT_TILE_CHOICES, pms.DEFAULT_BLK_CHOICES),
               "small": ((16, 64), (32, 128))}


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


def port_cfg(ti, tj, tk, blk) -> MemoryControllerConfig:
    return MemoryControllerConfig(cache=CacheEngineConfig(tile_i=ti, tile_j=tj, tile_k=tk),
                                  dma=DMAEngineConfig(blk=blk))


def ref_cfg(ti, tj, tk, blk) -> JConfig:
    return JConfig(cache=JCache(tile_i=ti, tile_j=tj, tile_k=tk), dma=JDMA(blk=blk))


def geometry(cfg) -> tuple[int, int, int, int]:
    c = cfg.cache
    return (c.tile_i, c.tile_j, c.tile_k, cfg.dma.blk)


def assert_same_layout_terms(got, want, kernel):
    """nblocks, padding and the stream term equal; for MTTKRP, whose lanes
    differ from the reference's 128 by a constant factor, the output term,
    weighted by the output tile's fills, too.  The input tiles' fills no
    longer price a term (the port's factors come from HBM once): they are
    compared through the plans' `tile_fills()` and the occupancy model's
    `_analytic_layout`."""
    assert (got.nblocks, got.padding_fraction) == (want.nblocks, want.padding_fraction)
    assert got.t_stream == pytest.approx(want.t_stream, rel=1e-12, abs=0)
    if kernel == "mttkrp":  # rank 4: 4 lanes here, 128 there
        assert got.t_out * 32 == pytest.approx(want.t_out, rel=1e-12, abs=0)


def kernel_args(kernel: str, nmodes: int):
    """(rank, core_ranks) the search takes for each kernel: mixed ranks."""
    if kernel == "ttmc":
        return 4, (3, 5, 2, 4, 3)[:nmodes]
    if kernel == "tt":
        return 4, (3, 5, 2, 4)[: nmodes - 1]
    return 4, None


# --- layout statistics, bit for bit ------------------------------------------


@pytest.mark.parametrize("fixture", FIXTURES)
def test_hypergraph_stats_and_traffic_models_match(request, fixture):
    st = request.getfixturevalue(fixture)
    tst = to_port(st)
    assert dataclasses.asdict(thg.stats(tst)) == dataclasses.asdict(jhg.stats(st))
    for mode in range(st.nmodes):
        for rank in (1, 16, 100):
            assert (dataclasses.asdict(thg.approach1_traffic(tst, mode, rank))
                    == dataclasses.asdict(jhg.approach1_traffic(st, mode, rank)))
            assert (dataclasses.asdict(thg.approach2_traffic(tst, mode, rank))
                    == dataclasses.asdict(jhg.approach2_traffic(st, mode, rank)))
            assert thg.remap_overhead(tst, mode, rank) == jhg.remap_overhead(st, mode, rank)
            assert (thg.approach1_traffic(tst, mode, rank).bytes()
                    == jhg.approach1_traffic(st, mode, rank).bytes())


@pytest.mark.parametrize("fixture", FIXTURES)
def test_fingerprint_and_mode_histogram_match(request, fixture):
    st = request.getfixturevalue(fixture)
    tst = to_port(st)
    assert tst.fingerprint() == st.fingerprint()
    assert tst.fingerprint() is tst.fingerprint()  # cached on the instance
    for m in range(st.nmodes):
        np.testing.assert_array_equal(tst.mode_histogram(m), st.mode_histogram(m))
    other = tcoo.SparseTensor(st.indices, st.values * 2, st.shape)
    assert other.fingerprint() != tst.fingerprint()


@pytest.mark.parametrize("geom", [(256, 256, 256, 256), (16, 64, 16, 32), (64, 16, 128, 128)])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_tile_fills_match(request, fixture, geom):
    st = request.getfixturevalue(fixture)
    tst = to_port(st)
    ti, tj, tk, blk = geom
    for m in range(st.nmodes):
        got = plan_blocks(tst, m, tile_i=ti, tile_j=tj, tile_k=tk, blk=blk, device="cpu")
        want = jplan_blocks(st, m, tile_i=ti, tile_j=tj, tile_k=tk, blk=blk)
        assert got.tile_fills() == want.tile_fills()
        assert got.nblocks == want.nblocks
        assert got.padding_fraction() == want.padding_fraction()


@pytest.mark.parametrize("kernel", ["mttkrp", "ttmc", "tt"])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_analytic_layout_and_stream_match_for_every_candidate(request, fixture, kernel):
    """Every candidate of the default grid, in the reference's order: the
    occupancy estimate (nblocks, fills, padding) and the stream term are
    the reference's; the port keeps all 256 (they all fit an H100 CTA)."""
    st = request.getfixturevalue(fixture)
    tst = to_port(st)
    hs_t, hs_j = thg.stats(tst), jhg.stats(st)
    for geom in GRID:
        for m in range(st.nmodes):
            assert (pms._analytic_layout(hs_t, m, port_cfg(*geom))
                    == jpms._analytic_layout(hs_j, m, ref_cfg(*geom)))
    rank, core_ranks = kernel_args(kernel, st.nmodes)
    for m in range(st.nmodes):
        got = pms.search(tst, m, rank, spec=SPEC, top_k=len(GRID), kernel=kernel, core_ranks=core_ranks)
        want = jpms.search(st, m, rank, spec=BIG_TPU, top_k=len(GRID), kernel=kernel,
                           core_ranks=core_ranks)
        assert len(got) == len(want) == len(GRID)
        ref = {geometry(e.cfg): e for e in want}
        for e in got:
            assert_same_layout_terms(e, ref[geometry(e.cfg)], kernel)
        # ties keep the enumeration order, as the reference's stable sort
        assert [e.t_total for e in got] == sorted(e.t_total for e in got)


@pytest.mark.parametrize("grid", sorted(EXACT_GRIDS))
@pytest.mark.parametrize("kernel", ["mttkrp", "ttmc", "tt"])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_exact_search_layout_matches(request, fixture, kernel, grid):
    """exact=True builds a plan per candidate: the plans' nblocks, padding
    and stream term are the reference's for every candidate."""
    st = request.getfixturevalue(fixture)
    tst = to_port(st)
    rank, core_ranks = kernel_args(kernel, st.nmodes)
    tiles, blks = EXACT_GRIDS[grid]
    n = len(tiles) ** 3 * len(blks)
    for m in range(st.nmodes):
        kw = dict(tile_choices=tiles, blk_choices=blks, exact=True, top_k=n, kernel=kernel,
                  core_ranks=core_ranks)
        got = pms.search(tst, m, rank, spec=SPEC, device="cpu", **kw)
        want = {geometry(e.cfg): e for e in jpms.search(st, m, rank, spec=BIG_TPU, **kw)}
        assert len(got) == len(want) == n
        for e in got:
            assert_same_layout_terms(e, want[geometry(e.cfg)], kernel)
        if grid == "small":  # every candidate's plans: the fills to the bit
            for ti, tj, tk, blk in itertools.product(tiles, tiles, tiles, blks):
                kw = dict(tile_i=ti, tile_j=tj, tile_k=tk, blk=blk)
                assert (plan_blocks(tst, m, device="cpu", **kw).tile_fills()
                        == jplan_blocks(st, m, **kw).tile_fills())


# --- the port's own terms, against closed forms ------------------------------


def stream_bytes(plan) -> int:
    return plan.nblocks * plan.blk * 4 * (1 + plan.n_in + 1)


def sectors(lanes: int) -> int:
    return -(-lanes * 4 // 32) * 32


def expected_terms(plan, in_lanes, out_lanes, flops_per_nnz, flush_slots, launch, spec=SPEC):
    """The port's terms written out from the plan: the stream, each input
    factor read from HBM once, the output tile per fill, the flops; the
    gathers (each real slot's input rows in 32-byte sectors) and the row
    runs' flushes at the L2 rate; the wave share of `launch`'s grid."""
    fills = plan.tile_fills()
    factor = sum(rows * w * 4 for rows, w in zip(plan.in_rows, in_lanes))
    out = fills["A"] * plan.tile_i * out_lanes * 4
    gather = plan.nnz * sum(sectors(w) for w in in_lanes)
    slots = plan.nblocks * plan.blk
    unit = min(flush_slots or 64 * plan.blk, 64 * plan.blk, slots)
    real = unit * (1 - plan.padding_fraction())
    runs = plan.nnz / real * plan.tile_i * (1 - math.exp(-real / plan.tile_i))
    held = spec.sms * launch.ctas_per_sm
    waves = min(max(held // launch.slices, math.ceil(plan.nblocks / 64)), plan.nblocks) \
        * launch.slices / held
    return (stream_bytes(plan) / spec.hbm_bw, factor / spec.hbm_bw, out / spec.hbm_bw,
            plan.nnz * flops_per_nnz / spec.peak_flops_f32, gather / spec.l2_bw,
            runs * sectors(out_lanes) / spec.l2_bw, waves / max(1.0, waves + 0.5))


def assert_terms(est, want):
    got = (est.t_stream, est.t_factor, est.t_out, est.t_compute, est.t_gather, est.t_flush,
           est.wave_share)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert est.t_reread == 0.0  # one CTA per block range at these widths
    assert est.t_total == pytest.approx(
        max(est.t_mem + est.t_gather + est.t_flush, est.t_compute)
        / (est.occupancy * est.step_share * est.wave_share), rel=1e-12)


@pytest.mark.parametrize("rank", [4, 6, 16])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_mttkrp_terms_closed_form(request, fixture, rank):
    """Lanes: the rank rounded up to 4; flops: N per non-zero and lane (the
    kernel skips padding slots and computes every padded lane)."""
    st = to_port(request.getfixturevalue(fixture))
    cfg = port_cfg(64, 16, 32, 64)
    ws = make_planned_cp_als(st, rank, cfg=cfg, device="cpu")
    rp = ((rank + 3) // 4) * 4
    for m, est in ws.pms_estimates().items():
        plan = ws.plan_for(m)
        assert_terms(est, expected_terms(plan, [rp] * plan.n_in, rp, st.nmodes * rp, 2048,
                                         cfg.mttkrp_launch(SPEC, rp, plan.n_in)))
        assert est.padding_fraction == plan.padding_fraction() and est.nblocks == plan.nblocks


def test_ttmc_terms_closed_form(tensor4d):
    """Lanes: each input's rank rounded up to 4, the output's product of
    ranks rounded up to 4; flops: the Kronecker chain's multiplies
    (r_a, r_a r_b, ...) and one add per output column."""
    st = to_port(tensor4d)
    cr = (3, 5, 2, 6)
    cfg = port_cfg(32, 16, 64, 64)
    ws = make_planned_tucker(st, cr, cfg=cfg, device="cpu")
    for m, est in ws.pms_estimates().items():
        plan = ws.plan_for(m)
        ins = [cr[k] for k in plan.in_modes]
        a, b, c = ins
        flops = a + a * b + a * b * c + a * b * c
        assert_terms(est, expected_terms(plan, [((r + 3) // 4) * 4 for r in ins],
                                         ((a * b * c + 3) // 4) * 4, flops, 8192,
                                         cfg.ttmc_launch(SPEC, tuple(ins))))


def test_tt_terms_closed_form(tensor4d):
    """Lanes: the true rl * rr of each interface and of the output; flops:
    2 rl rr per matrix step after each chain's first row, rl_m for the
    value, 2 rl_m rr_m for the product and sum."""
    st = to_port(tensor4d)
    tr = (3, 5, 2)
    pairs = [(1, 3), (3, 5), (5, 2), (2, 1)]
    cfg = port_cfg(32, 16, 64, 64)
    ws = make_planned_tt(st, tr, cfg=cfg, device="cpu")
    # chain steps after the first: mode 0: right chain (2,1) first, then
    # (5,2), (3,5); mode 1: left (1,3); right (2,1), (5,2); ...
    chains = {0: 2 * (5 * 2 + 3 * 5), 1: 2 * (5 * 2), 2: 2 * (3 * 5), 3: 2 * (3 * 5 + 5 * 2)}
    for m, est in ws.pms_estimates().items():
        plan = ws.plan_for(m)
        rl, rr = pairs[m]
        in_pairs = tuple(pairs[k] for k in plan.in_modes)
        assert_terms(est, expected_terms(plan, [a * b for a, b in in_pairs], rl * rr,
                                         chains[m] + rl + 2 * rl * rr, None,
                                         cfg.tt_launch(SPEC, in_pairs, m)))


# Shared memory per CTA from the kernels' layouts (csrc/*.cu), written out:
# (dynamic, static) bytes, row parts, column slices.
MTTKRP_SMEM = [
    # rank, n_in, tile_i: runs of 8 warps and the carry (2*8+1)*G*NQ*16 B, 2,048 sorted
    # slots, row counts; static 100
    ((16, 2, 256), ((2 * 8 + 1) * 4 * 16 + 2048 * 16 + 256 * 4, 100), 1, 1),
    ((4, 3, 128), ((2 * 8 + 1) * 4 * 16 + 2048 * 24 + 128 * 4, 100), 1, 1),
    ((256, 2, 8192), ((2 * 8 + 1) * 32 * 2 * 16 + 2048 * 16 + 4096 * 4, 100), 2, 1),
    ((1100, 4, 1024), ((2 * 8 + 1) * 32 * 8 * 16 + 2048 * 24 + 1024 * 4, 100), 1, 2),
]
TTMC_SMEM = [
    # in_ranks, tile_i: edges 8*2*NQ*32*16 B, row counts; static 16 KB permutation + 96
    (((16, 16), 256), (8 * 2 * 2 * 32 * 16 + 256 * 4, 16480), 1, 1),
    (((5, 2), 256), (8 * 2 * 1 * 32 * 16 + 256 * 4, 16480), 1, 1),
    (((100, 100), 512), (8 * 2 * 8 * 32 * 16 + 512 * 4, 16480), 1, 10),
    (((3, 5, 2), 8192), (8 * 2 * 1 * 32 * 16 + 4096 * 4, 16480), 2, 1),
]


@pytest.mark.parametrize("case", MTTKRP_SMEM, ids=str)
def test_mttkrp_smem_closed_form(case):
    (rank, n_in, tile_i), (dyn, static), parts, slices = case
    launch = port_cfg(tile_i, 256, 256, 256).mttkrp_launch(SPEC, rank_padded(rank), n_in)
    assert (launch.smem_bytes, launch.row_parts, launch.col_slices) == (dyn + static, parts, slices)
    assert launch.fits and launch.slices == parts * slices


@pytest.mark.parametrize("case", TTMC_SMEM, ids=str)
def test_ttmc_smem_closed_form(case):
    (in_ranks, tile_i), (dyn, static), parts, slices = case
    launch = port_cfg(tile_i, 256, 256, 256).ttmc_launch(SPEC, in_ranks)
    assert (launch.smem_bytes, launch.row_parts, launch.col_slices) == (dyn + static, parts, slices)
    assert launch.fits


def test_tt_smem_closed_form():
    """The TT-core kernel's tile, staged slots and chain vectors; static
    slot fields 2 x 256 x 8 + 2 x 256 x 4 + 32 bytes for 2 inputs."""
    static = 2 * 256 * 8 + 2 * 256 * 4 + 32
    budget = SPEC.smem_per_block - static
    cfg = port_cfg(256, 256, 256, 256)
    # middle mode at (16, 16): copy path, 256 columns in one slice, a 64 KB
    # tile cap -> 4 row parts of 64 rows, 256 staged slots of 32 floats
    mid = cfg.tt_launch(SPEC, ((1, 16), (16, 1)), 1)
    assert (mid.smem_bytes, mid.row_parts, mid.col_slices, mid.fits) == (
        (64 * 256 + 256 * 32) * 4 + 64 * 4 + static, 4, 1, True)
    # first mode: register path (no chain vectors), 16 columns, one part
    first = cfg.tt_launch(SPEC, ((16, 16), (16, 1)), 0)
    assert (first.smem_bytes, first.row_parts, first.col_slices) == (
        (256 * 16 + 256 * 20) * 4 + 256 * 4 + static, 1, 1)
    # a 4-mode middle core takes the warp path: 2 x 8 chain vectors
    warp = cfg.tt_launch(SPEC, ((1, 3), (5, 2), (2, 1)), 1)  # rl_m 3, rr_m 5
    assert warp.smem_bytes == (256 * 16 + 256 * (4 + 8) + 2 * 8 * 8) * 4 + 256 * 4 + 3 * 2048 + 2080
    # a small budget: row parts double until a slot fits; then fewer slots
    small = GPUSpec(smem_per_block=static + 1824)
    part = cfg.tt_launch(small, ((16, 16), (16, 1)), 0)
    assert (part.row_parts, part.fits) == (16, True)
    assert part.smem_bytes == (16 * 16 + ((1824 - 16 * 16 * 4 - 16 * 4) // 80) * 20) * 4 + 16 * 4 + static
    assert not cfg.tt_launch(GPUSpec(smem_per_block=static), ((16, 16), (16, 1)), 0).fits
    assert budget > 0


# CTAs per SM: 233,472 bytes of an SM's shared memory over (the CTA's + the
# 1 KB reserved), against the CTAs per SM each kernel keeps registers for.
OCCUPANCY = [
    # MTTKRP rank 16, 3 modes, tile 256: 34,912 B -> 6 CTAs fit, 4 wanted
    (lambda c: c.mttkrp_launch(SPEC, 16, 2), 1.0),
    # rank 256 (2 quads a lane): 2 wanted; 5 fit
    (lambda c: c.mttkrp_launch(SPEC, 256, 2), 1.0),
    # TTMc (16, 16): 33,888 B -> 6 fit, 4 wanted
    (lambda c: c.ttmc_launch(SPEC, (16, 16)), 1.0),
    # TT-core first mode at (16, 16), tile 256: 44,064 B -> 5 fit, 4 wanted
    (lambda c: c.tt_launch(SPEC, ((16, 16), (16, 1)), 0), 1.0),
    # TT-core middle mode: 104,736 B -> 2 fit of 4
    (lambda c: c.tt_launch(SPEC, ((1, 16), (16, 1)), 1), 0.5),
]


@pytest.mark.parametrize("case", range(len(OCCUPANCY)))
def test_occupancy_closed_form(case):
    launch_at, want = OCCUPANCY[case]
    assert launch_at(port_cfg(256, 256, 256, 256)).occupancy == want
    # TT-core's first mode at tile_i 1,024: 96,288 B -> 2 of 4; 512: 3 of 4
    first = ((16, 16), (16, 1))
    assert port_cfg(1024, 256, 256, 256).tt_launch(SPEC, first, 0).occupancy == 0.5
    assert port_cfg(512, 256, 256, 256).tt_launch(SPEC, first, 0).occupancy == 0.75


@pytest.mark.parametrize("blk,share", [(64, 0.25), (128, 0.5), (256, 1.0), (1024, 1.0)])
def test_tt_step_share_closed_form(tiny_tensor, blk, share):
    """A TT-core step takes at most 256 slots of one block: smaller blocks
    leave a share of the CTA's threads idle, and t_total pays for it; the
    MTTKRP and TTMc kernels sort across blocks and pay nothing."""
    cfg = port_cfg(256, 256, 256, blk)
    assert cfg.tt_launch(SPEC, ((16, 16), (16, 1)), 0).step_share == share
    assert cfg.mttkrp_launch(SPEC, 16, 2).step_share == cfg.ttmc_launch(SPEC, (16, 16)).step_share == 1.0
    st = to_port(tiny_tensor)
    est = make_planned_tt(st, (3, 5), cfg=cfg, device="cpu").pms_estimates()[0]
    assert est.step_share == share
    assert est.t_total == pytest.approx(max(est.t_mem + est.t_l2, est.t_compute)
                                        / (est.occupancy * share * est.wave_share), rel=1e-12)


def test_reread_term_prices_every_part_and_slice(tiny_tensor):
    """Each row part and column slice reads its range's stream again:
    t_reread = (parts x slices - 1) x t_stream; zero where one CTA takes a
    range."""
    st = to_port(tiny_tensor)
    cfg = port_cfg(1024, 64, 64, 64)
    mid = make_planned_tt(st, (16, 16), cfg=cfg, device="cpu").pms_estimates()[1]
    assert (mid.row_parts, mid.col_slices) == (16, 1)  # 1,024 rows x 256 columns
    assert mid.t_reread == pytest.approx(15 * mid.t_stream, rel=1e-12)
    assert mid.t_mem == pytest.approx(mid.t_stream + mid.t_reread + mid.t_factor + mid.t_out)
    plan = make_planned_mttkrp(st, 0, 1_100, cfg=cfg, device="cpu").plan
    wide = pms.predict_from_plan(plan, 1_100, cfg)
    assert (wide.row_parts, wide.col_slices) == (1, 2)  # 275 quads: two slices of 256
    assert wide.t_reread == pytest.approx(wide.t_stream, rel=1e-12)
    assert pms.predict_from_plan(plan, 16, cfg).t_reread == 0.0


def test_estimates_report_the_launch(tiny_tensor):
    st = to_port(tiny_tensor)
    cfg = port_cfg(128, 64, 64, 64)
    op = make_planned_mttkrp(st, 0, 16, cfg=cfg, device="cpu")
    est = pms.predict_from_plan(op.plan, 16, cfg)
    launch = cfg.mttkrp_launch(SPEC, 16, 2)
    assert (est.smem_bytes, est.row_parts, est.col_slices) == (
        launch.smem_bytes, launch.row_parts, launch.col_slices)
    ws = make_planned_cp_als(st, 16, cfg=cfg, device="cpu")
    assert ws.smem_model_bytes() == launch.smem_bytes
    assert est.bottleneck == ("memory" if est.t_mem + est.t_l2 >= est.t_compute else "compute")
    assert est.t_total == (max(est.t_mem + est.t_l2, est.t_compute)
                           / (est.occupancy * est.step_share * est.wave_share))


# --- the search's contracts ---------------------------------------------------


def test_search_counts_configs_and_prunes_by_shared_memory(tiny_tensor):
    st = to_port(tiny_tensor)
    metrics.reset()
    out = pms.search(st, 0, 16, top_k=3)
    snap = metrics.snapshot()["counters"]
    assert snap["pms.configs_evaluated{kernel=mttkrp,sharded=false}"] == len(GRID)
    assert snap["pms.searches{kernel=mttkrp,sharded=false}"] == 1
    assert len(out) == 3 and out[0].t_total <= out[1].t_total <= out[2].t_total
    # A CTA budget below the kernel's sorted slots: nothing fits, and
    # make_planned_* refuses rather than fall back to a default.
    tight = GPUSpec(smem_per_block=2048 * 16)
    assert pms.search(st, 0, 16, spec=tight) == []
    with pytest.raises(ValueError, match="fits shared memory"):
        make_planned_mttkrp(st, 0, 16, auto_tune=True, spec=tight, device="cpu")
    # tile_i 128 fits a budget that 1,024 rows of counts do not
    mid = GPUSpec(smem_per_block=(2 * 8 + 1) * 4 * 16 + 2048 * 16 + 512 * 4 + 100)
    kept = pms.search(st, 0, 16, spec=mid, top_k=len(GRID))
    assert {e.cfg.cache.tile_i for e in kept} == {128, 256, 512}
    metrics.reset()


def test_search_argument_contracts(tiny_tensor):
    st = to_port(tiny_tensor)
    with pytest.raises(ValueError, match="unknown kernel"):
        pms.search(st, 0, 4, kernel="nope")
    with pytest.raises(ValueError, match="requires core_ranks"):
        pms.search(st, 0, 4, kernel="ttmc")
    with pytest.raises(ValueError, match="full N-tuple"):
        pms.search(st, 0, 4, kernel="ttmc", core_ranks=(3, 3))
    with pytest.raises(ValueError, match="interior TT ranks"):
        pms.search(st, 0, 4, kernel="tt", core_ranks=(3, 3, 3))
    with pytest.raises(ValueError, match="unknown spec"):
        pms.search(st, 0, 4, spec="fast")
    hs = thg.stats(st)  # stats alone: analytic whatever `exact` says
    a = pms.search(hs, 1, 4, exact=True, top_k=4)
    b = pms.search(st, 1, 4, top_k=4)
    assert [geometry(e.cfg) for e in a] == [geometry(e.cfg) for e in b]
    assert pms.resolve_spec("default") == GPUSpec()


def test_exact_search_needs_a_device_without_gpu(tiny_tensor, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pms.search(to_port(tiny_tensor), 0, 4, exact=True)
    assert pms.search(to_port(tiny_tensor), 0, 4, top_k=1)  # the analytic one runs on the host


def test_nell2_size_analytic_search_prefers_large_tiles():
    """The occupancy model at NELL-2's published shape and nnz (no tensor is
    built), against what the card showed (scripts/torch_pms_probe.py and
    chip_smoke.py phase i, "NVIDIA H100 80GB HBM3, 700.00 W"): for
    every kernel the pick takes 1,024-row input tiles (the fewest groups,
    the least padding) and 128-row output tiles; the model puts the
    256-cube default at 1.1-1.3 times MTTKRP's pick, as the card did (2.22
    against 1.94-2.01 ms on low-padding geometries), not at the 4-5 times
    the fill-priced factor term gave; TT-core's middle mode takes 2 row
    parts at tile_i 128 (16.96 ms on the card) ahead of the default's 4
    (29.15 ms) and every 1,024-row tile's 16 (61.9-122.2 ms); and MTTKRP
    with 1,024-slot blocks at tile_i 128 (82% padding: 4.72-4.91 ms) ranks
    below the default."""
    hs = thg.HypergraphStats(nnz=76_879_419, nmodes=3, shape=(12_092, 9_184, 28_818),
                             degree_mean=(0.0,) * 3, degree_max=(0,) * 3, degree_cv=(0.0,) * 3,
                             occupied_frac=(0.0,) * 3)
    best = pms.search(hs, 0, 16, top_k=len(GRID))
    assert geometry(best[0].cfg)[1:3] == (1024, 1024) and best[0].cfg.cache.tile_i == 128
    default = next(e for e in best if e.cfg == MemoryControllerConfig())
    assert default.nblocks == pms._analytic_layout(hs, 0, MemoryControllerConfig())[0]
    assert 1.1 < default.t_total / best[0].t_total < 1.3
    rank_of = {geometry(e.cfg): k for k, e in enumerate(best)}
    assert rank_of[(128, 256, 256, 1024)] > rank_of[(256, 256, 256, 256)]
    assert all(math.isfinite(e.t_total) and e.row_parts == 1 for e in best)
    for kernel, ranks in (("ttmc", (16, 16, 16)), ("tt", (16, 16))):
        for m in range(3):
            top = pms.search(hs, m, 16, kernel=kernel, core_ranks=ranks, top_k=1)[0]
            assert geometry(top.cfg)[1:3] == (1024, 1024) and top.cfg.cache.tile_i == 128
    mid = pms.search(hs, 1, 16, kernel="tt", core_ranks=(16, 16), top_k=len(GRID))
    parts = {geometry(e.cfg): (k, e.row_parts) for k, e in enumerate(mid)}
    assert parts[geometry(mid[0].cfg)][1] == 2 and parts[(256, 256, 256, 256)][1] == 4
    assert all(parts[(256, 256, 256, 256)][0] < k for g, (k, p) in parts.items() if g[0] == 1024)
