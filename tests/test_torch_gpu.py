"""Port tests that need the card: the CUDA MTTKRP, TTMc and TT-core kernels
against their plain versions, and the CP-ALS, Tucker HOOI and TT-ALS paths
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
from repro_torch.core.coo import frostt_like
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


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("preset", ["tiny", "4d_small", "5d_small"])
def test_kernel_matches_plain_version(cuda, preset, geometry):
    """Kernel vs the plain version evaluated in float64 on the same inputs,
    relative to each output column's max."""
    st = frostt_like(preset)
    ws = make_planned_cp_als(st, 16, cfg=GEOMETRIES[geometry], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = mttkrp_blocked.launches
    for m in range(st.nmodes):
        plan = ws.plan_for(m)
        facs = [torch.randn((r, rank_padded(16)), generator=gen, device=cuda) for r in plan.in_rows]
        got = mttkrp_blocked(plan, facs)
        want = mttkrp_blocked_plain(dataclasses.replace(plan, vals=plan.vals.double()),
                                    [f.double() for f in facs])
        scale = want.abs().amax(0).clamp_min(1e-300)
        assert float(((got.double() - want).abs().amax(0) / scale).max()) <= TOL
    assert mttkrp_blocked.launches == before + st.nmodes


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


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("preset,core_ranks",
                         [(p, r) for p, rs in TUCKER_RANKS.items() for r in rs])
def test_ttmc_kernel_matches_plain_version(cuda, preset, core_ranks, geometry):
    """TTMc kernel vs the plain version evaluated in float64 on the same
    inputs, relative to each output column's max; padded lanes exactly 0."""
    st = frostt_like(preset)
    ws = make_planned_tucker(st, core_ranks, cfg=GEOMETRIES[geometry], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = ttmc_blocked.launches
    for m in range(st.nmodes):
        op = ws.ops[m]
        facs = [torch.randn((rows, rank_padded(r)), generator=gen, device=cuda)
                for rows, r in zip(op.plan.in_rows, op.in_ranks)]
        got = ttmc_blocked(op.plan, facs, op.in_ranks)
        want = ttmc_blocked_plain(dataclasses.replace(op.plan, vals=op.plan.vals.double()),
                                  [f.double() for f in facs], op.in_ranks)
        assert got.shape == want.shape
        assert not got[:, op.out_cols:].any()
        scale = want.abs().amax(0)[: op.out_cols].clamp_min(1e-300)
        err = (got.double() - want).abs().amax(0)[: op.out_cols] / scale
        assert float(err.max()) <= TOL
    assert ttmc_blocked.launches == before + st.nmodes


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


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("preset,tt_ranks", [(p, r) for p, rs in TT_RANKS.items() for r in rs])
def test_ttcore_kernel_matches_plain_version(cuda, preset, tt_ranks, geometry):
    """TT-core kernel vs the plain version evaluated in float64 on the same
    inputs, relative to each output column's max; padded lanes exactly 0."""
    st = frostt_like(preset)
    ws = make_planned_tt(st, tt_ranks, cfg=GEOMETRIES[geometry], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = ttcore_blocked.launches
    for m in range(st.nmodes):
        op = ws.ops[m]
        mats = [torch.randn((rows, rank_padded(a * b)), generator=gen, device=cuda)
                for rows, (a, b) in zip(op.plan.in_rows, op.in_rank_pairs)]
        got = ttcore_blocked(op.plan, mats, op.in_rank_pairs, op.n_left)
        want = ttcore_blocked_plain(dataclasses.replace(op.plan, vals=op.plan.vals.double()),
                                    [w.double() for w in mats], op.in_rank_pairs, op.n_left)
        assert got.shape == want.shape
        assert not got[:, op.out_cols:].any()
        scale = want.abs().amax(0)[: op.out_cols].clamp_min(1e-300)
        err = (got.double() - want).abs().amax(0)[: op.out_cols] / scale
        assert float(err.max()) <= TOL
    assert ttcore_blocked.launches == before + st.nmodes


def test_cuda_tt_fits_match_cpu(cuda):
    st = frostt_like("tiny")
    init = init_tt_cores(st.shape, (3, 5), seed=1, device=cuda)
    a = decompose(st, (3, 5), format="tt", iters=3, init_factors=init, device=cuda)
    b = decompose(st, (3, 5), format="tt", iters=3, init_factors=[c.cpu() for c in init],
                  device="cpu")
    assert max(abs(x - y) for x, y in zip(a.fit_history, b.fit_history)) <= TOL
