"""Port tests that need the card: the CUDA MTTKRP, TTMc and TT-core kernels
against their plain versions (also at the wide ranks that need column
slices or smaller steps: CP rank 256, Tucker (100, 8, 100), TT (24, 24),
(40, 48) and (100, 100)), and the CP-ALS, Tucker HOOI and TT-ALS paths
on CUDA against the CPU path.  Marked `gpu`;
they skip where torch sees no CUDA device.  Run them on a GPU machine
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
from repro_torch.kernels.ops import make_planned_cp_als
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
    """CP rank 256: a 256 x 256 output tile (256 KB) does not fit in a CTA,
    so the kernel takes it in column slices."""
    check_mttkrp(cuda, frostt_like(preset), 256, GEOMETRIES[geometry])


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
    "5d_small": [(3, 4, 2, 5, 3)],
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
