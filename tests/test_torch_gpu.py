"""Port tests that need the card: the CUDA MTTKRP kernel against its plain
version, and the CP-ALS path on CUDA against the CPU path.  Marked `gpu`;
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
