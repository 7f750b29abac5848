"""Port tests that need the card: the CUDA MTTKRP, TTMc and TT-core kernels
against their plain versions (also at the wide ranks that need column
slices, wider groups or smaller steps: CP rank 256 and 1,100, Tucker
(100, 8, 100), TT (24, 24), (40, 48) and (100, 100); at tile_i = 8,192,
which splits the MTTKRP and TTMc row counts into row parts; and on a
tensor whose hot rows fill whole block ranges; at the geometries the PMS
may pick: blocks of 128 and 1,024 slots, tiles (1,024, 128, 512)), and the
CP-ALS, Tucker HOOI and TT-ALS paths on CUDA, also with auto_tune=True,
against the CPU path; every launch of the MTTKRP kernel on the hot rows
within the bound, 20 times over; the compute patterns (approach 1 and 2)
on the card against float64; the one-shot dispatchers' launches and
plan cache; and the kernels' wide paths on tensors of 6 and 7 modes (5 and
6 input modes; MTTKRP also on hot rows, 20 launches a mode), with CP,
Tucker and TT on a 6-mode tensor against the CPU path; the resilience
layer on the card: each kernel at the admission ladder's blocks (64 to 8
slots) against float64, each format recovering from an injected NaN under
"restart" and "fallback" (no launch after a fallback), a checkpoint round
trip on CUDA tensors and a resumed run, and `plan_with_budget` on a preset.
Marked `gpu`; they
skip where torch sees no CUDA device.  Run them on a GPU machine
(`--noconftest`: the shared conftest imports JAX, which a torch-only
machine need not have) with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.api import decompose
from repro_torch.core.coo import frostt_like, synthetic_tensor
from repro_torch.core.memctrl import CacheEngineConfig, DMAEngineConfig, MemoryControllerConfig
from repro_torch.kernels.mttkrp import mttkrp_blocked, mttkrp_blocked_plain, rank_padded
import repro_torch.kernels.ops as ops_module
from repro_torch.core.mttkrp import mttkrp
from repro_torch.core.remap import remap_stable
from repro_torch.kernels.ops import make_planned_cp_als
from repro_torch.kernels.ref import ttcore_ref, ttmc_ref
from repro_torch.kernels.tt import ttcore_blocked, ttcore_blocked_plain
from repro_torch.kernels.ttm import ttmc_blocked, ttmc_blocked_plain
from repro_torch.tt import init_tt_cores, make_planned_tt
from repro_torch.tucker import init_tucker_factors, make_planned_tucker

pytestmark = pytest.mark.gpu

# Atomics add a row's contributions in a varying order: float32 rounding.
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# Default geometry, and small tiles with blocks wider than a CTA's 256
# threads: many output-tile flushes per CTA and several chunks per block.
GEOMETRIES = {
    "default": MemoryControllerConfig(),
    "small_tiles_wide_blocks": MemoryControllerConfig(
        cache=CacheEngineConfig(tile_i=8, tile_j=16, tile_k=4), dma=DMAEngineConfig(blk=640)),
}


# An output tile of 8,192 rows: more than the MTTKRP and TTMc kernels keep
# row counts for in a CTA (4,096), so both split it into row parts.
BIG_TILE = MemoryControllerConfig(cache=CacheEngineConfig(tile_i=8192))


def wide_tensor():
    """A 3-mode tensor wide enough for the ranks that overflowed the kernels'
    shared memory before they sized their steps at launch."""
    return synthetic_tensor((200, 200, 200), 5_000, seed=0, skew=0.8)


def assert_cols_within(got, want, ncols):
    """Padded lanes exactly 0; true columns within TOL of each column's max."""
    assert got.shape == want.shape
    assert not got[:, ncols:].any()
    scale = want.abs().amax(0)[:ncols].clamp_min(1e-300)
    err = (got.double() - want).abs().amax(0)[:ncols] / scale
    assert float(err.max()) <= TOL


def check_mttkrp(cuda, st, rank, cfg):
    """MTTKRP kernel vs the plain version evaluated in float64 on the same
    inputs, relative to each output column's max, on every mode."""
    ws = make_planned_cp_als(st, rank, cfg=cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = mttkrp_blocked.launches
    for m in range(st.nmodes):
        plan = ws.plan_for(m)
        facs = [torch.randn((r, rank_padded(rank)), generator=gen, device=cuda) for r in plan.in_rows]
        got = mttkrp_blocked(plan, facs)
        want = mttkrp_blocked_plain(dataclasses.replace(plan, vals=plan.vals.double()),
                                    [f.double() for f in facs])
        assert_cols_within(got, want, rank_padded(rank))
    assert mttkrp_blocked.launches == before + st.nmodes


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("preset", ["tiny", "4d_small", "5d_small"])
def test_kernel_matches_plain_version(cuda, preset, geometry):
    """Kernel vs the plain version evaluated in float64 on the same inputs,
    relative to each output column's max."""
    check_mttkrp(cuda, frostt_like(preset), 16, GEOMETRIES[geometry])


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("preset", ["tiny", "4d_small", "5d_small"])
def test_kernel_matches_plain_version_at_rank_256(cuda, preset, geometry):
    """CP rank 256: 64 float4 quads a row, two a lane of a 32-lane group."""
    check_mttkrp(cuda, frostt_like(preset), 256, GEOMETRIES[geometry])


@pytest.mark.parametrize("rank", [16, 256])
@pytest.mark.parametrize("preset", ["tiny", "4d_small"])
def test_kernel_at_tile_i_8192(cuda, preset, rank):
    """tile_i = 8,192: the tile splits into row parts, each CTA keeping only
    its rows' slots."""
    check_mttkrp(cuda, frostt_like(preset), rank, BIG_TILE)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_kernel_in_column_slices(cuda, geometry):
    """CP rank 1,100: more columns than a 32-lane group holds (1,024), so the
    kernel takes the row in two column slices."""
    check_mttkrp(cuda, frostt_like("tiny"), 1_100, GEOMETRIES[geometry])


def hot_row_tensor():
    """Zipf skew 3 on 2,000 rows: a few rows hold most of every block range,
    so their runs span many of a CTA's groups and warps."""
    return synthetic_tensor((2_000, 300, 400), 50_000, seed=0, skew=3.0)


@pytest.mark.parametrize("rank", [16, 256])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_kernel_on_hot_rows(cuda, geometry, rank):
    """A hot row's float32 sums stay within TOL: its groups' shares reach
    the output once per sorted chunk, not once per group."""
    check_mttkrp(cuda, hot_row_tensor(), rank, GEOMETRIES[geometry])


@pytest.mark.parametrize("rank", [16, 256])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_kernel_on_hot_rows_every_launch(cuda, geometry, rank):
    """The hot rows' sums take an order that varies from launch to launch:
    each of 20 launches on every mode stays within TOL of float64."""
    st = hot_row_tensor()
    ws = make_planned_cp_als(st, rank, cfg=GEOMETRIES[geometry], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for m in range(st.nmodes):
        plan = ws.plan_for(m)
        facs = [torch.randn((r, rank_padded(rank)), generator=gen, device=cuda) for r in plan.in_rows]
        want = mttkrp_blocked_plain(dataclasses.replace(plan, vals=plan.vals.double()),
                                    [f.double() for f in facs])
        for _ in range(20):
            assert_cols_within(mttkrp_blocked(plan, facs), want, rank_padded(rank))


@pytest.mark.parametrize("method", ["approach1", "approach2"])
@pytest.mark.parametrize("preset", ["tiny", "4d_small", "5d_small"])
def test_compute_patterns_on_the_card(cuda, preset, method):
    """Approach 1 (segmented sums over the remapped stream) and approach 2
    (float32 atomics) against float64 on the same inputs, every mode."""
    st = frostt_like(preset)
    gen = torch.Generator(device=cuda).manual_seed(2)
    idx, val = torch.from_numpy(st.indices).to(cuda), torch.from_numpy(st.values).to(cuda)
    facs = [torch.randn((s, 16), generator=gen, device=cuda) for s in st.shape]
    for m in range(st.nmodes):
        s_idx, s_val, _ = remap_stable(idx, val, m)
        got = mttkrp(s_idx, s_val, facs, m, st.shape[m], method=method)
        want = mttkrp(s_idx, s_val.double(), [f.double() for f in facs], m, st.shape[m],
                      method="approach2")
        assert got.device.type == cuda.type and got.dtype == torch.float32
        assert_cols_within(got, want, 16)


def test_dispatchers_launch_the_kernels(cuda, monkeypatch):
    """mttkrp_auto, tucker_auto and tt_auto launch their kernel once a call;
    a second mttkrp_auto call hits the plan cache and builds nothing; each
    output within TOL of its chunked reference in float64."""
    st = frostt_like("4d_small")
    ops_module.plan_cache_clear()
    built = []
    real = ops_module.make_planned_mttkrp
    monkeypatch.setattr(ops_module, "make_planned_mttkrp",
                        lambda *a, **k: built.append(a) or real(*a, **k))
    gen = torch.Generator(device=cuda).manual_seed(3)
    idx, val = torch.from_numpy(st.indices).to(cuda), torch.from_numpy(st.values).to(cuda)
    facs = [torch.randn((s, 16), generator=gen, device=cuda) for s in st.shape]
    before = mttkrp_blocked.launches
    first = ops_module.mttkrp_auto(st, facs, 0, device=cuda)
    second = ops_module.mttkrp_auto(st, facs, 0, device=cuda)
    assert mttkrp_blocked.launches == before + 2 and len(built) == 1
    stats = ops_module.plan_cache_stats()
    assert stats["by_kind"]["mttkrp"] == {"hits": 1, "misses": 1}
    want = mttkrp(idx, val.double(), [f.double() for f in facs], 0, st.shape[0], method="approach2")
    assert_cols_within(first, want, 16)
    assert_cols_within(second, want, 16)

    tfacs = [torch.randn((s, r), generator=gen, device=cuda) for s, r in zip(st.shape, (5, 4, 6, 3))]
    before = ttmc_blocked.launches
    got = ops_module.tucker_auto(st, tfacs, 0, device=cuda)
    assert ttmc_blocked.launches == before + 1
    assert_cols_within(got, ttmc_ref(idx, val.double(), [f.double() for f in tfacs], 0, st.shape[0]),
                       got.shape[1])

    cores = init_tt_cores(st.shape, (4, 3, 5), seed=3, device=cuda)
    before = ttcore_blocked.launches
    got = ops_module.tt_auto(st, cores, 0, device=cuda)
    assert ttcore_blocked.launches == before + 1
    assert_cols_within(got, ttcore_ref(idx, val.double(), [c.double() for c in cores], 0, st.shape[0]),
                       got.shape[1])
    ops_module.plan_cache_clear()


def test_cuda_fits_match_cpu(cuda):
    st = frostt_like("tiny")
    gen = torch.Generator(device=cuda).manual_seed(1)
    init = [torch.randn((s, 8), generator=gen, device=cuda) / math.sqrt(8) for s in st.shape]
    a = decompose(st, 8, iters=3, init_factors=init, device=cuda).fit_history
    b = decompose(st, 8, iters=3, init_factors=[f.cpu() for f in init], device="cpu").fit_history
    assert max(abs(x - y) for x, y in zip(a, b)) <= TOL


# Mixed core ranks on every preset, and outputs wider than one 64-column
# slice of the kernel's grid (72, 120 and 256 columns on some modes).
TUCKER_RANKS = {
    "tiny": [(3, 5, 2), (16, 16, 16)],
    "4d_small": [(5, 4, 6, 3)],
    "5d_small": [(3, 4, 2, 5, 3), (4, 4, 4, 4, 4)],
}


def check_ttmc(cuda, st, core_ranks, cfg):
    """TTMc kernel vs the plain version evaluated in float64 on the same
    inputs, relative to each output column's max; padded lanes exactly 0."""
    ws = make_planned_tucker(st, core_ranks, cfg=cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = ttmc_blocked.launches
    for m in range(st.nmodes):
        op = ws.ops[m]
        facs = [torch.randn((rows, rank_padded(r)), generator=gen, device=cuda)
                for rows, r in zip(op.plan.in_rows, op.in_ranks)]
        got = ttmc_blocked(op.plan, facs, op.in_ranks)
        want = ttmc_blocked_plain(dataclasses.replace(op.plan, vals=op.plan.vals.double()),
                                  [f.double() for f in facs], op.in_ranks)
        assert_cols_within(got, want, op.out_cols)
    assert ttmc_blocked.launches == before + st.nmodes


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("preset,core_ranks",
                         [(p, r) for p, rs in TUCKER_RANKS.items() for r in rs])
def test_ttmc_kernel_matches_plain_version(cuda, preset, core_ranks, geometry):
    """TTMc kernel vs the plain version evaluated in float64 on the same
    inputs, relative to each output column's max; padded lanes exactly 0."""
    check_ttmc(cuda, frostt_like(preset), core_ranks, GEOMETRIES[geometry])


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_ttmc_kernel_at_wide_ranks(cuda, geometry):
    """Core ranks (100, 8, 100): mode 1's input ranks sum to 200, so fewer
    than 256 slots fit in a step beside the tile; modes 0 and 2 have 800
    output columns and mode 1 10,000."""
    check_ttmc(cuda, wide_tensor(), (100, 8, 100), GEOMETRIES[geometry])


@pytest.mark.parametrize("core_ranks", [(3, 5, 2), (16, 16, 16)])
@pytest.mark.parametrize("preset", ["tiny", "4d_small"])
def test_ttmc_kernel_at_tile_i_8192(cuda, preset, core_ranks):
    """tile_i = 8,192: the TTMc kernel's row counts split into two row parts."""
    if preset == "4d_small":
        core_ranks = core_ranks + core_ranks[:1]
    check_ttmc(cuda, frostt_like(preset), core_ranks, BIG_TILE)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_ttmc_kernel_on_hot_rows(cuda, geometry):
    """Zipf skew 3 on 2,000 rows: a few rows hold most of every block range,
    so their runs are split over many windows and warps."""
    check_ttmc(cuda, hot_row_tensor(), (16, 16, 16), GEOMETRIES[geometry])


def test_cuda_tucker_fits_match_cpu(cuda):
    st = frostt_like("tiny")
    init = init_tucker_factors(st.shape, (3, 5, 2), seed=1, device=cuda)
    a = decompose(st, (3, 5, 2), format="tucker", iters=3, init_factors=init, device=cuda)
    b = decompose(st, (3, 5, 2), format="tucker", iters=3, init_factors=[f.cpu() for f in init],
                  device="cpu")
    assert max(abs(x - y) for x, y in zip(a.fit_history, b.fit_history)) <= TOL


# Mixed TT ranks on every preset (bonds that change at every chain step),
# and the NELL-2 shape's (16, 16): 256 output columns on the middle mode.
TT_RANKS = {
    "tiny": [(3, 5), (16, 16)],
    "4d_small": [(4, 3, 5)],
    "5d_small": [(2, 4, 3, 2)],
}


def check_ttcore(cuda, st, tt_ranks, cfg):
    """TT-core kernel vs the plain version evaluated in float64 on the same
    inputs, relative to each output column's max; padded lanes exactly 0."""
    ws = make_planned_tt(st, tt_ranks, cfg=cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = ttcore_blocked.launches
    for m in range(st.nmodes):
        op = ws.ops[m]
        mats = [torch.randn((rows, rank_padded(a * b)), generator=gen, device=cuda)
                for rows, (a, b) in zip(op.plan.in_rows, op.in_rank_pairs)]
        got = ttcore_blocked(op.plan, mats, op.in_rank_pairs, op.n_left)
        want = ttcore_blocked_plain(dataclasses.replace(op.plan, vals=op.plan.vals.double()),
                                    [w.double() for w in mats], op.in_rank_pairs, op.n_left)
        assert_cols_within(got, want, op.out_cols)
    assert ttcore_blocked.launches == before + st.nmodes


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("preset,tt_ranks", [(p, r) for p, rs in TT_RANKS.items() for r in rs])
def test_ttcore_kernel_matches_plain_version(cuda, preset, tt_ranks, geometry):
    """TT-core kernel vs the plain version evaluated in float64 on the same
    inputs, relative to each output column's max; padded lanes exactly 0."""
    check_ttcore(cuda, frostt_like(preset), tt_ranks, GEOMETRIES[geometry])


# Bonds never run on a card before the kernel sized its steps at launch:
# 17-32, above 32 (W_1 rows of 1,920 floats), and (100, 100), whose middle
# mode stages 200 floats per slot and whose W_1 rows (10,000 floats) are read
# from L2 rather than staged.
TT_WIDE = {"tiny_24_24": ("tiny", (24, 24)), "tiny_40_48": ("tiny", (40, 48)),
           "wide_100_100": ("wide", (100, 100))}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("case", sorted(TT_WIDE))
def test_ttcore_kernel_at_wide_bonds(cuda, case, geometry):
    tensor, tt_ranks = TT_WIDE[case]
    st = wide_tensor() if tensor == "wide" else frostt_like(tensor)
    check_ttcore(cuda, st, tt_ranks, GEOMETRIES[geometry])


def test_cuda_tt_fits_match_cpu(cuda):
    st = frostt_like("tiny")
    init = init_tt_cores(st.shape, (3, 5), seed=1, device=cuda)
    a = decompose(st, (3, 5), format="tt", iters=3, init_factors=init, device=cuda)
    b = decompose(st, (3, 5), format="tt", iters=3, init_factors=[c.cpu() for c in init],
                  device="cpu")
    assert max(abs(x - y) for x, y in zip(a.fit_history, b.fit_history)) <= TOL


# Geometries the PMS's search may pick that the default never runs: blocks
# of 128 and 1,024 slots, and unequal tiles (1,024 output rows).
PMS_GEOMETRIES = {
    "blk_128": MemoryControllerConfig(dma=DMAEngineConfig(blk=128)),
    "blk_1024": MemoryControllerConfig(dma=DMAEngineConfig(blk=1024)),
    "tiles_1024_128_512": MemoryControllerConfig(
        cache=CacheEngineConfig(tile_i=1024, tile_j=128, tile_k=512)),
}


@pytest.mark.parametrize("geometry", sorted(PMS_GEOMETRIES))
@pytest.mark.parametrize("preset", ["tiny", "4d_small", "5d_small"])
def test_kernels_at_searched_geometries(cuda, preset, geometry):
    """Each kernel against its float64 plain version at the geometry."""
    st, cfg = frostt_like(preset), PMS_GEOMETRIES[geometry]
    check_mttkrp(cuda, st, 16, cfg)
    check_ttmc(cuda, st, TUCKER_RANKS[preset][0], cfg)
    check_ttcore(cuda, st, TT_RANKS[preset][0], cfg)


def cpu_init(fmt, st, rank):
    cpu = torch.device("cpu")
    if fmt == "cp":
        gen = torch.Generator().manual_seed(1)
        return [torch.randn((s, rank), generator=gen) / math.sqrt(rank) for s in st.shape]
    if fmt == "tucker":
        return init_tucker_factors(st.shape, rank, seed=1, device=cpu)
    return init_tt_cores(st.shape, rank, seed=1, device=cpu)


@pytest.mark.parametrize("fmt,rank", [("cp", 8), ("tucker", (3, 5, 2)), ("tt", (3, 5))])
def test_auto_tune_runs_on_the_card(cuda, fmt, rank):
    """decompose(auto_tune=True) launches the format's kernel at the PMS's
    pick, and gives the fits of the same run on the CPU."""
    st = frostt_like("tiny")
    counter = {"cp": mttkrp_blocked, "tucker": ttmc_blocked, "tt": ttcore_blocked}[fmt]
    init = cpu_init(fmt, st, rank)
    before = counter.launches
    a = decompose(st, rank, format=fmt, iters=3, init_factors=[f.to(cuda) for f in init],
                  auto_tune=True, device=cuda)
    assert counter.launches == before + 3 * st.nmodes
    b = decompose(st, rank, format=fmt, iters=3, init_factors=init, auto_tune=True, device="cpu")
    assert max(abs(x - y) for x, y in zip(a.fit_history, b.fit_history)) <= TOL


# Tensors of 6 and 7 modes: plans of 5 and 6 input modes, which each kernel
# takes on its wide path (the inputs' pointers in a table in device memory,
# a loop over them at run time).
WIDE_MODES = {5: (24, 20, 18, 16, 14, 12), 6: (16, 14, 12, 12, 10, 10, 8)}


def wide_modes_tensor(n_in):
    return synthetic_tensor(WIDE_MODES[n_in], 20_000, seed=0, skew=0.8)


@pytest.mark.parametrize("rank", [16, 256])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("n_in", [5, 6])
def test_wide_path_mttkrp(cuda, n_in, geometry, rank):
    check_mttkrp(cuda, wide_modes_tensor(n_in), rank, GEOMETRIES[geometry])


@pytest.mark.parametrize("rank", [16, 256])
@pytest.mark.parametrize("n_in", [5, 6])
def test_wide_path_mttkrp_on_hot_rows_every_launch(cuda, n_in, rank):
    """Zipf skew 3 on every mode of a 6- or 7-mode tensor: each of 20
    launches on every mode within TOL of float64."""
    shape = (2_000, 300, 400, 200, 100, 50, 40)[: n_in + 1]
    st = synthetic_tensor(shape, 50_000, seed=0, skew=3.0)
    ws = make_planned_cp_als(st, rank, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for m in range(st.nmodes):
        plan = ws.plan_for(m)
        facs = [torch.randn((r, rank_padded(rank)), generator=gen, device=cuda) for r in plan.in_rows]
        want = mttkrp_blocked_plain(dataclasses.replace(plan, vals=plan.vals.double()),
                                    [f.double() for f in facs])
        for _ in range(20):
            assert_cols_within(mttkrp_blocked(plan, facs), want, rank_padded(rank))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("n_in", [5, 6])
def test_wide_path_ttmc(cuda, n_in, geometry):
    """Mixed core ranks (2, 3, 4, ...): up to 576 Kronecker columns, in
    column slices of the widest lanes' quads."""
    core_ranks = tuple(2 + m % 3 for m in range(n_in + 1))
    check_ttmc(cuda, wide_modes_tensor(n_in), core_ranks, GEOMETRIES[geometry])


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("n_in", [5, 6])
def test_wide_path_ttcore(cuda, n_in, geometry):
    """Mixed TT ranks: every chain step changes bond, left and right chains
    of up to 5 steps."""
    tt_ranks = tuple(3 + k % 3 for k in range(n_in))
    check_ttcore(cuda, wide_modes_tensor(n_in), tt_ranks, GEOMETRIES[geometry])


@pytest.mark.parametrize("fmt", ["cp", "tucker", "tt"])
def test_wide_path_decompose_matches_cpu(cuda, fmt):
    """CP, Tucker and TT on a 6-mode tensor on the card against the CPU path
    from the same initial factors: fits within 1e-5 over 3 iterations."""
    st = wide_modes_tensor(5)
    if fmt == "cp":
        rank = 8
        gen = torch.Generator().manual_seed(1)
        init = [torch.randn((s, rank), generator=gen) / math.sqrt(rank) for s in st.shape]
    elif fmt == "tucker":
        rank = (3,) * st.nmodes
        init = [f.cpu() for f in init_tucker_factors(st.shape, rank, seed=1, device=cuda)]
    else:
        rank = (3,) * (st.nmodes - 1)
        init = [c.cpu() for c in init_tt_cores(st.shape, rank, seed=1, device=cuda)]
    a = decompose(st, rank, format=fmt, iters=3, init_factors=[f.to(cuda) for f in init], device=cuda)
    b = decompose(st, rank, format=fmt, iters=3, init_factors=init, device="cpu")
    assert max(abs(x - y) for x, y in zip(a.fit_history, b.fit_history)) <= TOL


# The admission ladder's blocks (repro_torch.resilience.plan_with_budget
# halves blk from 256 down to FLOOR_BLK = 8): each kernel at each of them.
LADDER_BLKS = (64, 32, 16, 8)


@pytest.mark.parametrize("blk", LADDER_BLKS)
@pytest.mark.parametrize("preset", ["tiny", "4d_small"])
def test_kernels_at_ladder_blocks(cuda, preset, blk):
    """Each kernel against its float64 plain version at blocks of 64 to 8
    slots: fewer slots than a step holds, many blocks a range."""
    st, cfg = frostt_like(preset), MemoryControllerConfig(dma=DMAEngineConfig(blk=blk))
    check_mttkrp(cuda, st, 16, cfg)
    check_ttmc(cuda, st, TUCKER_RANKS[preset][0], cfg)
    check_ttcore(cuda, st, TT_RANKS[preset][0], cfg)


RESILIENCE_RANKS = {"cp": 8, "tucker": (3, 5, 2), "tt": (3, 5)}


@pytest.mark.parametrize("policy", ["restart", "fallback"])
@pytest.mark.parametrize("fmt", ["cp", "tucker", "tt"])
def test_recovery_on_the_card(cuda, fmt, policy):
    """A NaN injected after iteration 1 on the card: the guard fires at
    iteration 2 and the run recovers to its clean run's final fit within
    1e-4 (the kernels' float32 sums vary in order); after a fallback no
    kernel launches again."""
    from repro_torch.resilience import GuardConfig
    from repro_torch.testing import faults

    st, rank = frostt_like("tiny"), RESILIENCE_RANKS[fmt]
    counter = {"cp": mttkrp_blocked, "tucker": ttmc_blocked, "tt": ttcore_blocked}[fmt]
    make = {"cp": make_planned_cp_als, "tucker": make_planned_tucker, "tt": make_planned_tt}[fmt]
    init = [f.to(cuda) for f in cpu_init(fmt, st, rank)]
    clean = decompose(st, rank, format=fmt, iters=5, init_factors=init, device=cuda)
    ws = make(st, rank, device=cuda)
    faults.inject_nan_factor(ws, at_iter=1)
    before = counter.launches
    out = decompose(st, rank, format=fmt, iters=5, init_factors=init, planned=ws,
                    guards=GuardConfig(policy=policy), device=cuda)
    assert len(out.fit_history) == 5 and all(math.isfinite(f) for f in out.fit_history)
    assert abs(out.fit_history[-1] - clean.fit_history[-1]) <= 1e-4
    # restart: 3 sweeps, then 5 from the start; fallback: the 3 sweeps before the switch
    assert counter.launches - before == st.nmodes * (8 if policy == "restart" else 3)


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """CUDA tensors saved and restored onto the card bit for bit; a resumed
    CP run starts from the saved padded factors exactly."""
    from repro_torch.train import CheckpointManager

    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"facs": (torch.randn((7, 4), generator=gen, device=cuda),
                     torch.randn((5, 4), generator=gen, device=cuda)),
            "fits": torch.tensor([0.1, 0.2], dtype=torch.float64, device=cuda)}
    mgr = CheckpointManager(str(tmp_path / "tree"))
    mgr.save(1, tree)
    _, back = mgr.restore(device=cuda)
    for a, b in zip((*tree["facs"], tree["fits"]), (*back["facs"], back["fits"])):
        assert b.device == a.device and torch.equal(a, b)

    st = frostt_like("tiny")
    ws = make_planned_cp_als(st, 8, device=cuda)
    decompose(st, 8, iters=2, planned=ws, checkpoint_path=str(tmp_path / "cp"), device=cuda)
    _, saved = CheckpointManager(str(tmp_path / "cp")).restore(device=cuda)
    seen = {}
    inner = ws._sweep_call

    def first_input(facs, *args, it):
        seen.setdefault("facs", tuple(f.clone() for f in facs))
        return inner(facs, *args, it=it)

    ws._sweep_call = first_input
    out = decompose(st, 8, iters=4, planned=ws, checkpoint_path=str(tmp_path / "cp"), device=cuda)
    assert all(torch.equal(a, b) for a, b in zip(seen["facs"], saved["facs"]))
    assert out.fit_history[:2] == saved["fits"].tolist() and len(out.fit_history) == 4


def test_plan_with_budget_on_the_card(cuda):
    """The ladder on a preset on the card: a budget at the blk-64 rung's
    total admits a planned workspace at blk 64 or above, whose decompose
    launches the kernel; one byte over the reference footprint takes
    approach 1 after every rung down to blk 8, and launches nothing."""
    from repro_torch.api import _lane_ranks
    from repro_torch.resilience import admission_bytes, plan_with_budget, reference_footprint_bytes

    st = frostt_like("4d_small")
    build = lambda c: make_planned_cp_als(st, 16, cfg=c, device=cuda)  # noqa: E731
    budget = admission_bytes(build(MemoryControllerConfig(dma=DMAEngineConfig(blk=64))))["total_bytes"]
    ws, decision = plan_with_budget(build, budget)
    assert decision["admitted"] == "pallas" and decision["blk"] >= 64
    assert admission_bytes(ws)["total_bytes"] <= budget
    before = mttkrp_blocked.launches
    decompose(st, 16, iters=2, planned=ws, device=cuda)
    assert mttkrp_blocked.launches == before + 2 * st.nmodes
    ref = reference_footprint_bytes(st, _lane_ranks("cp", 16, st.nmodes))
    ws, decision = plan_with_budget(build, ref + 1, reference_bytes=ref)
    assert ws is None and decision["admitted"] == "reference"
    assert [a["blk"] for a in decision["ladder"]] == [256, 128, 64, 32, 16, 8]
    before = mttkrp_blocked.launches
    out = decompose(st, 16, iters=2, hbm_budget=ref + 1, device=cuda)
    assert mttkrp_blocked.launches == before and len(out.fit_history) == 2
