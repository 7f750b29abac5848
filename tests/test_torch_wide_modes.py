"""Tensors of 6 and 7 modes (plans of 5 and 6 input modes) through the port
on the CPU: plans bit for bit against the reference's, the three kernels'
plain versions against the reference's plan oracles, CP, Tucker and TT
`decompose` against `repro.api.decompose(method="pallas")`, and the
shared-memory launch models and the PMS search, which price the kernels'
wide paths there.  The reference takes any N >= 3, so the port does too.

The tensors are the smallest that have the modes: every case stays well
under 10 s.  Tucker's factors are compared through their projectors, which
move by (float32 noise) / (the gap between the R-th and (R+1)-th Gram
eigenvalues): the 6-mode tensor is seed 0, whose smallest relative gap over
2 iterations at core ranks (3,)*6 is 3.4% (float64 HOOI); at seed 1 it is
0.5%, and both packages' float32 projectors sit 5e-4 (the reference) and
2e-3 (the port) from float64's there."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import decompose as jax_decompose
from repro.core.coo import random_factors
from repro.core.coo import synthetic_tensor as jax_synthetic_tensor
from repro.core.remap import plan_blocks as jax_plan_blocks
from repro.kernels.ref import mttkrp_plan_ref as jax_mttkrp_plan_ref
from repro.kernels.ref import ttcore_plan_ref as jax_ttcore_plan_ref
from repro.kernels.ref import ttmc_plan_ref as jax_ttmc_plan_ref
from repro.tucker import init_tucker_factors as jax_init_tucker_factors
from repro_torch.api import decompose
from repro_torch.convert import factors_from_numpy, ttstate_to_numpy, tuckerstate_to_numpy
from repro_torch.core import coo as tcoo
from repro_torch.core import memctrl, pms
from repro_torch.core.hypergraph import stats as hg_stats
from repro_torch.core.memctrl import GPUSpec, MemoryControllerConfig
from repro_torch.core.remap import plan_blocks
from repro_torch.kernels.mttkrp import check_plan_args, mttkrp_blocked, mttkrp_blocked_plain, rank_padded
from repro_torch.kernels.ops import _tt_bond_pairs
from repro_torch.kernels.tt import tt_out_cols, ttcore_blocked, ttcore_blocked_plain
from repro_torch.kernels.ttm import kron_cols, ttmc_blocked, ttmc_blocked_plain
from test_torch_remap import assert_plans_equal
from test_torch_tt import carried as tt_carried
from test_torch_tt_als import assert_same_model
from test_torch_ttm import carried as ttm_carried
from test_torch_tucker import assert_same_decomposition

ITERS = 2
RANK = 4
COL_TOL = 1e-5  # the plain versions against the oracles, per output column's max
TILES = dict(tile_i=4, tile_j=4, tile_k=4, blk=8)
# (shape, nnz, seed): the smallest tensors of 6 and 7 modes that exercise
# several tiles per mode at TILES (on the seed, see above).
TENSORS = {
    "6d": ((12, 10, 9, 8, 7, 6), 600, 0),
    "7d": ((8, 7, 6, 6, 5, 5, 4), 400, 2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this module's cases.  The suite runs in
    several worker processes on one machine; oversubscribed, torch's
    OpenMP threads spin-wait, and this module's cases ran 10-100 times
    slower than alone.  One thread gives the same results (every
    tolerance here is far above float32 summation order)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(TENSORS))
def wide(request):
    shape, nnz, seed = TENSORS[request.param]
    return jax_synthetic_tensor(shape, nnz, seed=seed, skew=0.5)


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


def assert_cols_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    assert (np.abs(got - want).max(axis=0) / scale).max() <= COL_TOL


@pytest.mark.parametrize("tiles", [TILES, {}], ids=["small_tiles", "default"])
def test_plans_match_reference_bit_for_bit(wide, tiles):
    for mode in range(wide.nmodes):
        plan = plan_blocks(to_port(wide), mode, device="cpu", **tiles)
        assert plan.n_in == wide.nmodes - 1
        assert_plans_equal(jax_plan_blocks(wide, mode, **tiles), plan)


def test_mttkrp_plain_matches_plan_oracle(wide):
    rp = rank_padded(RANK)
    for mode in range(wide.nmodes):
        ref, plan, _, _ = ttm_carried(wide, mode, (RANK,) * wide.nmodes, tiles=TILES)
        rng = np.random.default_rng(mode)
        facs = []
        for rows, m in zip(ref.in_rows, ref.in_modes):
            f = np.zeros((rows, rp), np.float32)
            f[: wide.shape[m], :RANK] = rng.standard_normal((wide.shape[m], RANK))
            facs.append(f)
        tf = factors_from_numpy(facs, "cpu")
        got = mttkrp_blocked_plain(plan, tf).numpy()
        assert_cols_close(got[:, :RANK],
                          np.asarray(jax_mttkrp_plan_ref(ref, [jnp.asarray(f) for f in facs], rp))[:, :RANK])
        # the wrapper takes the plain version for CPU tensors, launching nothing
        before = mttkrp_blocked.launches
        np.testing.assert_array_equal(mttkrp_blocked(plan, tf).numpy(), got)
        assert mttkrp_blocked.launches == before
        assert not got[:, RANK:].any()


def test_ttmc_plain_matches_plan_oracle(wide):
    core_ranks = tuple(2 + m % 2 for m in range(wide.nmodes))  # mixed ranks: 2, 3, 2, ...
    for mode in range(wide.nmodes):
        ref, plan, in_ranks, facs = ttm_carried(wide, mode, core_ranks, tiles=TILES)
        ncols = kron_cols(in_ranks)
        tf = factors_from_numpy(facs, "cpu")
        got = ttmc_blocked_plain(plan, tf, in_ranks).numpy()
        assert_cols_close(got[:, :ncols],
                          jax_ttmc_plan_ref(ref, [jnp.asarray(f) for f in facs], in_ranks))
        np.testing.assert_array_equal(ttmc_blocked(plan, tf, in_ranks).numpy(), got)
        assert not got[:, ncols:].any()


def test_ttcore_plain_matches_plan_oracle(wide):
    tt_ranks = tuple(2 + k % 2 for k in range(wide.nmodes - 1))
    for mode in range(wide.nmodes):
        ref, plan, in_pairs, mats = tt_carried(wide, mode, tt_ranks, tiles=TILES)
        ncols = tt_out_cols(in_pairs, mode)
        tm = factors_from_numpy(mats, "cpu")
        got = ttcore_blocked_plain(plan, tm, in_pairs, mode).numpy()
        assert_cols_close(got[:, :ncols],
                          jax_ttcore_plan_ref(ref, [jnp.asarray(w) for w in mats], in_pairs, mode))
        np.testing.assert_array_equal(ttcore_blocked(plan, tm, in_pairs, mode).numpy(), got)
        assert not got[:, ncols:].any()


def test_check_plan_args_takes_any_n_in_and_names_a_short_plan(wide):
    plan = plan_blocks(to_port(wide), 0, device="cpu", **TILES)
    facs = [np.zeros((r, 4), np.float32) for r in plan.in_rows]
    check_plan_args(plan, factors_from_numpy(facs, "cpu"), plan.vals.dtype, (4,) * plan.n_in)
    short = dataclasses.replace(plan, in_locs=plan.in_locs[:1], block_in=plan.block_in[:1],
                                in_tiles=plan.in_tiles[:1], in_rows=plan.in_rows[:1],
                                in_modes=plan.in_modes[:1])
    with pytest.raises(ValueError, match="2 or more input modes"):
        check_plan_args(short, factors_from_numpy(facs[:1], "cpu"), plan.vals.dtype, (4,))


def test_cp_matches_reference(wide):
    init = [np.asarray(f) for f in random_factors(jax.random.PRNGKey(0), wide.shape, RANK)]
    ref = jax_decompose(wide, RANK, format="cp", method="pallas", iters=ITERS, seed=0)
    out = decompose(to_port(wide), RANK, iters=ITERS, init_factors=init, device="cpu")
    np.testing.assert_allclose(out.fit_history, ref.fit_history, rtol=0, atol=1e-5)
    for got, want in zip(out.factors, ref.factors):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_tucker_matches_reference(wide):
    # 243 Kronecker columns at 6 modes; 2s at 7 modes (64 columns) keep the
    # JAX reference's interpret-mode kernel and its (P, P) eigh small.
    core_ranks = (3 if wide.nmodes == 6 else 2,) * wide.nmodes
    init = [np.asarray(f) for f in jax_init_tucker_factors(jax.random.PRNGKey(0), wide.shape, core_ranks)]
    ref = jax_decompose(wide, core_ranks, format="tucker", method="pallas", iters=ITERS, seed=0)
    out = tuckerstate_to_numpy(decompose(to_port(wide), core_ranks, format="tucker", iters=ITERS,
                                         init_factors=init, device="cpu"))
    assert_same_decomposition(out, ref.factors, ref.core, ref.fit_history)


def test_tt_matches_reference(wide):
    tt_ranks = (3,) * (wide.nmodes - 1)
    ref = jax_decompose(wide, tt_ranks, format="tt", method="pallas", iters=ITERS, init="svd")
    out = ttstate_to_numpy(decompose(to_port(wide), tt_ranks, format="tt", iters=ITERS, init="svd",
                                     device="cpu"))
    assert len(out["fit_history"]) == ITERS
    assert_same_model(out["cores"], out["fit_history"], ref.cores, ref.fit_history, wide.indices)


def test_auto_tune_runs_and_matches_the_default_geometry():
    """auto_tune=True on the 6-mode tensor searches the wide paths' launch
    models per mode and builds the plans it picks; the fits agree with the
    default geometry's (float32 sums over other plans)."""
    shape, nnz, seed = TENSORS["6d"]
    pst = to_port(jax_synthetic_tensor(shape, nnz, seed=seed, skew=0.5))
    for fmt, rank in (("cp", RANK), ("tucker", (3,) * 6), ("tt", (3,) * 5)):
        tuned = decompose(pst, rank, format=fmt, iters=ITERS, seed=0, auto_tune=True, device="cpu")
        plain = decompose(pst, rank, format=fmt, iters=ITERS, seed=0, device="cpu")
        np.testing.assert_allclose(tuned.fit_history, plain.fit_history, rtol=0, atol=1e-4)


SPEC = GPUSpec()


@pytest.mark.parametrize("n_in", [5, 6, 9])
def test_mttkrp_wide_launch_model(n_in):
    """The wide path keeps (2 + n_in) ints a sorted slot, 2,048 slots where
    they fit, and builds for 2 CTAs per SM."""
    cfg = MemoryControllerConfig()
    launch = cfg.mttkrp_launch(SPEC, 16, n_in)
    static = (2 * 8 + 1 + 8) * 4
    assert launch.smem_bytes == (2 * 8 + 1) * 4 * 16 + 2048 * 4 * (2 + n_in) + 256 * 4 + static
    assert launch.fits and (launch.row_parts, launch.col_slices) == (1, 1)
    assert launch.occupancy == min(2, SPEC.smem_per_sm // (launch.smem_bytes + 1024)) / 2
    # a budget that holds fewer slots stages fewer, and still fits
    small = GPUSpec(smem_per_block=static + (2 * 8 + 1) * 4 * 16 + 256 * 4 + 100 * 4 * (2 + n_in) + 3)
    assert cfg.mttkrp_launch(small, 16, n_in).smem_bytes == small.smem_per_block - 3
    assert not cfg.mttkrp_launch(GPUSpec(smem_per_block=static + 100), 16, n_in).fits
    with pytest.raises(ValueError, match="2 or more"):
        cfg.mttkrp_launch(SPEC, 16, 1)


def test_templates_sorted_slot_bytes_unchanged():
    """sizeof(Sorted<N_IN>) of the 2-4-input templates: 16, 24, 24."""
    assert [memctrl._mttkrp_sorted_bytes(n) for n in (2, 3, 4, 5, 6)] == [16, 24, 24, 28, 32]


@pytest.mark.parametrize("n_in", [5, 6])
def test_ttmc_wide_launch_model(n_in):
    cfg = MemoryControllerConfig()
    in_ranks = (4,) * n_in
    launch = cfg.ttmc_launch(SPEC, in_ranks)
    nquads = 4 ** (n_in - 1)
    nq = next((q for q in (1, 2, 4) if nquads <= 32 * q), 8)
    fixed = 8 * 2 * nq * 32 * 16 + 256 * 4 + (n_in - 1) * nq * 32 * 4
    static = 2 * 8 * 4 + 8 * 4
    chunk = min(8192, (SPEC.smem_per_block - static - fixed) // 2)
    assert launch.smem_bytes == fixed + 2 * chunk + static
    assert launch.fits and launch.col_slices == -(-nquads // (32 * nq))


@pytest.mark.parametrize("n_in", [5, 6])
def test_tt_wide_launch_model(n_in):
    cfg = MemoryControllerConfig()
    pairs = _tt_bond_pairs((4,) * n_in, n_in + 1)
    mode = 2
    in_pairs = tuple(p for m, p in enumerate(pairs) if m != mode)
    launch = cfg.tt_launch(SPEC, in_pairs, mode)
    # a 16-column slice (rl_m x rr_m = 4 x 4), one tile part; staged slots of
    # 8 floats, n_in row offsets, a value and a tile row; the warps' chain
    # vectors of 4 floats; s_warp
    slot = 8 * 4 + n_in * 8 + 8
    fixed = (256 * 16 + 8 * 2 * 4) * 4 + 256 * 4
    chunk = min(256, (SPEC.smem_per_block - 8 * 4 - fixed) // slot)
    assert launch.smem_bytes == fixed + chunk * slot + 8 * 4
    assert launch.fits and (launch.row_parts, launch.col_slices) == (1, 1)


@pytest.mark.parametrize("kernel", ["mttkrp", "ttmc", "tt"])
def test_pms_search_on_a_six_mode_tensor(kernel):
    shape, nnz, seed = TENSORS["6d"]
    pst = to_port(jax_synthetic_tensor(shape, nnz, seed=seed, skew=0.5))
    hs = hg_stats(pst)
    kw = dict(rank=RANK, core_ranks=(3,) * 6 if kernel == "ttmc" else (3,) * 5)
    for mode in (0, 3, 5):
        analytic = pms.search(hs, mode, kernel=kernel, top_k=10**6, **kw)
        exact = pms.search(pst, mode, kernel=kernel, exact=True, top_k=10**6, device="cpu", **kw)
        assert analytic and exact
        assert all(e.t_total > 0 and np.isfinite(e.t_total) for e in analytic + exact)
        assert {e.cfg for e in analytic} == {e.cfg for e in exact}
