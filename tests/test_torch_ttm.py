"""Port parity for the module that holds the TTMc kernel
(`repro_torch.kernels.ttm`): its plain version against the reference's
Pallas kernel (interpret mode, as the reference's own tests run it) and the
reference's oracles, on the same plans and padded factors, carried over by
`repro_torch.convert`; on every mode of 3/4/5-mode tensors with equal and
mixed core ranks.  On the CPU the wrapper takes the plain version."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coo import synthetic_tensor as jax_synthetic_tensor
from repro.core.remap import plan_blocks as jax_plan_blocks
from repro.kernels.ref import ttmc_plan_ref as jax_ttmc_plan_ref
from repro.kernels.ref import ttmc_ref as jax_ttmc_ref
from repro.kernels.ttm_pallas import ttmc_pallas_call
from repro.kernels.workspace import _visited_row_mask
from repro_torch.convert import factors_from_numpy, plan_from_numpy
from repro_torch.core.coo import SparseTensor
from repro_torch.core.remap import plan_blocks
from repro_torch.kernels.mttkrp import mttkrp_blocked, rank_padded
from repro_torch.kernels.ops import make_planned_ttmc
import repro_torch.kernels.ref as ref_module
from repro_torch.kernels.ref import ttmc_plan_ref, ttmc_ref
from repro_torch.kernels.tt import ttcore_blocked
from repro_torch.kernels.ttm import cols_padded, kron_cols, ttmc_blocked, ttmc_blocked_plain
from test_torch_remap import assert_plans_equal

# Largest error allowed relative to each output column's max: float32 sums
# over the same terms taken in another order (the Pallas kernel's one-hot
# matmul vs index_add_).  The reference's own TTMc tests allow 2e-4 absolute.
COL_TOL = 1e-5
TILES = dict(tile_i=8, tile_j=16, tile_k=4, blk=16)
# Equal core ranks, and mixed ones: equal ranks would hide a transposed
# Kronecker digit order.
CORE_RANKS = {
    "tiny_tensor": {"equal": (3, 3, 3), "mixed": (3, 5, 2)},
    "tensor4d": {"equal": (3, 3, 3, 3), "mixed": (3, 4, 2, 3)},
    "tensor5d": {"equal": (3, 3, 3, 3, 3), "mixed": (2, 3, 4, 3, 2)},
}
CASES = [(f, k) for f in CORE_RANKS for k in ("equal", "mixed")]


def assert_cols_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    err = (np.abs(got - want).max(axis=0) / scale).max()
    assert err <= COL_TOL, err


def carried(st, mode, core_ranks, seed=0, tiles=TILES):
    """The reference plan (small tiles, or `tiles`; {} for the default
    geometry), the same plan in the port, the input ranks, and padded
    factors (numpy, made from a seed) for its input modes."""
    ref = jax_plan_blocks(st, mode, **tiles)
    plan = plan_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}, "cpu")
    in_ranks = tuple(core_ranks[m] for m in ref.in_modes)
    rng = np.random.default_rng(100 * seed + mode)
    facs = []
    for rows, m, r in zip(ref.in_rows, ref.in_modes, in_ranks):
        f = np.zeros((rows, rank_padded(r)), np.float32)
        f[: st.shape[m], :r] = rng.standard_normal((st.shape[m], r))
        facs.append(f)
    return ref, plan, in_ranks, facs


def pallas_interpret(ref, facs, in_ranks):
    nb, blk = ref.nblocks, ref.blk
    out = ttmc_pallas_call(
        jnp.asarray(ref.block_it),
        [jnp.asarray(t) for t in ref.block_in],
        jnp.asarray(ref.vals).reshape(nb, blk),
        jnp.asarray(ref.iloc).reshape(nb, blk),
        [jnp.asarray(l).reshape(nb, blk) for l in ref.in_locs],
        [jnp.asarray(f) for f in facs],
        tile_i=ref.tile_i, in_tiles=ref.in_tiles, in_ranks=in_ranks, blk=blk,
        out_rows=ref.out_rows, interpret=True,
    )
    mask = _visited_row_mask(ref.block_it, ref.tile_i, ref.out_rows)
    return np.where(mask[:, None] > 0, np.asarray(out), 0.0)[:, : kron_cols(in_ranks)]


@pytest.mark.parametrize("fixture,ranks", CASES)
def test_plain_matches_pallas_interpret_and_plan_refs(request, fixture, ranks):
    """Every mode: the plain version vs the interpret-mode Pallas kernel and
    both packages' plan oracles; padded lanes and rows exactly zero."""
    st = request.getfixturevalue(fixture)
    core_ranks = CORE_RANKS[fixture][ranks]
    for mode in range(st.nmodes):
        ref, plan, in_ranks, facs = carried(st, mode, core_ranks)
        ncols = kron_cols(in_ranks)
        got = ttmc_blocked_plain(plan, factors_from_numpy(facs, "cpu"), in_ranks).numpy()
        assert got.shape == (ref.out_rows, cols_padded(ncols))
        assert_cols_close(got[:, :ncols], pallas_interpret(ref, facs, in_ranks))
        assert_cols_close(got[:, :ncols], jax_ttmc_plan_ref(ref, [jnp.asarray(f) for f in facs], in_ranks))
        assert_cols_close(got[:, :ncols], ttmc_plan_ref(plan, factors_from_numpy(facs, "cpu"), in_ranks))
        assert not got[:, ncols:].any()
        assert not got[st.shape[mode]:].any()


@pytest.mark.parametrize("fixture,ranks", CASES)
def test_planned_ttmc_matches_raw_stream_refs(request, fixture, ranks):
    """`PlannedTTMC` (plan built by the port, default geometry, true-shape
    factors in) against `ttmc_ref` on the raw COO stream, in both packages."""
    st = request.getfixturevalue(fixture)
    core_ranks = CORE_RANKS[fixture][ranks]
    pst = SparseTensor(st.indices, st.values, st.shape)
    rng = np.random.default_rng(3)
    np_facs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(st.shape, core_ranks)]
    facs = factors_from_numpy(np_facs, "cpu")
    idx, val = torch.from_numpy(st.indices), torch.from_numpy(st.values)
    for mode in range(st.nmodes):
        op = make_planned_ttmc(pst, mode, core_ranks, device="cpu")
        assert op.in_ranks == tuple(core_ranks[m] for m in op.plan.in_modes)
        got = op(*(facs[m] for m in op.plan.in_modes))[: st.shape[mode]]
        assert got.shape == (st.shape[mode], op.out_cols)
        want = np.asarray(jax_ttmc_ref(jnp.asarray(st.indices), jnp.asarray(st.values),
                                       [jnp.asarray(f) for f in np_facs], mode, st.shape[mode]))
        assert_cols_close(got, want)
        assert_cols_close(ttmc_ref(idx, val, facs, mode, st.shape[mode]), want)


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_ttmc_ref_chunks_equal_one_step(request, fixture, monkeypatch):
    """`ttmc_ref` in steps of fewer non-zeros than the stream holds equals
    the same sum in one step: the reference's unchunked form, which
    `test_planned_ttmc_matches_raw_stream_refs` holds to the reference's
    `ttmc_ref`."""
    st = request.getfixturevalue(fixture)
    core_ranks = CORE_RANKS[fixture]["mixed"]
    rng = np.random.default_rng(8)
    np_facs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(st.shape, core_ranks)]
    facs = factors_from_numpy(np_facs, "cpu")
    idx, val = torch.from_numpy(st.indices), torch.from_numpy(st.values)
    for mode in range(st.nmodes):
        monkeypatch.setattr(ref_module, "REF_ELEMS", 1 << 40)  # one step
        whole = ttmc_ref(idx, val, facs, mode, st.shape[mode])
        monkeypatch.setattr(ref_module, "REF_ELEMS", 97 * 12)  # steps of fewer than nnz
        torch.testing.assert_close(ttmc_ref(idx, val, facs, mode, st.shape[mode]), whole,
                                   rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_takes_plain_version(tensor4d):
    """CPU tensors run the plain version and launch nothing."""
    before = ttmc_blocked.launches
    _, plan, in_ranks, facs = carried(tensor4d, 2, (3, 4, 2, 3))
    tf = factors_from_numpy(facs, "cpu")
    torch.testing.assert_close(ttmc_blocked(plan, tf, in_ranks), ttmc_blocked_plain(plan, tf, in_ranks),
                               rtol=0, atol=0)
    assert ttmc_blocked.launches == before == 0


def test_plain_chunking_is_exact(tiny_tensor, monkeypatch):
    """The plain version's block-aligned steps add up to the one-step sum,
    also when a step is smaller than one block's slot-columns."""
    from repro_torch.kernels import ttm as module

    _, plan, in_ranks, facs = carried(tiny_tensor, 0, (3, 5, 2))
    tf = factors_from_numpy(facs, "cpu")
    whole = ttmc_blocked_plain(plan, tf, in_ranks)
    for elems in (3 * plan.blk * kron_cols(in_ranks), 1):
        monkeypatch.setattr(module, "PLAIN_ELEMS", elems)
        assert_cols_close(ttmc_blocked_plain(plan, tf, in_ranks), whole)


# Malformed calls that both wrappers on the BlockPlan layout must reject,
# through their shared argument checks: (what is wrong, message matched).
MALFORMED = {
    "factor_count": "factors for",
    "factor_dtype": "float32",
    "factor_rows": r">= \d+",
    "factor_not_contiguous": "contiguous",
    "factor_narrow": "factor 1",
    "iloc_dtype": "plan.iloc",
    "vals_shape": "plan.vals",
    "block_in_dtype": r"plan.block_in\[0\]",
}


def malformed(case, plan, tf):
    if case == "factor_count":
        return plan, tf[:1]
    if case == "factor_dtype":
        return plan, [tf[0].double(), tf[1]]
    if case == "factor_rows":
        return plan, [tf[0][:1], tf[1]]
    if case == "factor_not_contiguous":
        return plan, [tf[0], tf[1].t().contiguous().t()]
    if case == "factor_narrow":
        return plan, [tf[0], tf[1][:, :1].contiguous()]
    if case == "iloc_dtype":
        return dataclasses.replace(plan, iloc=plan.iloc.long()), tf
    if case == "vals_shape":
        return dataclasses.replace(plan, vals=plan.vals[:-1]), tf
    return dataclasses.replace(plan, block_in=(plan.block_in[0].long(),) + plan.block_in[1:]), tf


@pytest.mark.parametrize("case", sorted(MALFORMED))
@pytest.mark.parametrize("wrapper", ["mttkrp", "ttmc", "ttcore"])
def test_wrappers_reject_the_same_malformed_calls(tiny_tensor, wrapper, case):
    _, plan, in_ranks, facs = carried(tiny_tensor, 1, (4, 4, 4))
    bad_plan, bad_facs = malformed(case, plan, factors_from_numpy(facs, "cpu"))
    with pytest.raises(ValueError, match=MALFORMED[case]):
        if wrapper == "mttkrp":
            mttkrp_blocked(bad_plan, bad_facs)
        elif wrapper == "ttmc":
            ttmc_blocked(bad_plan, bad_facs, in_ranks)
        else:  # mode 1 of a TT at ranks (4, 4): interface widths 4 and 4
            ttcore_blocked(bad_plan, bad_facs, ((1, 4), (4, 1)), 1)


def test_ttmc_rejects_bad_ranks(tiny_tensor):
    _, plan, in_ranks, facs = carried(tiny_tensor, 1, (4, 4, 4))
    tf = factors_from_numpy(facs, "cpu")
    with pytest.raises(ValueError, match="in_ranks"):
        ttmc_blocked(plan, tf, in_ranks[:1])
    with pytest.raises(ValueError, match="in_ranks"):
        ttmc_blocked(plan, tf, (0, 4))
    with pytest.raises(ValueError, match="factor 0"):
        ttmc_blocked(plan, tf, (5, 4))  # wider than the factor's 4 lanes


@pytest.mark.parametrize("in_ranks,ncols,padded", [((3, 5), 15, 16), ((16, 16), 256, 256),
                                                   ((2, 3, 4, 1), 24, 24), ((1, 1), 1, 4)])
def test_kron_cols_and_padding(in_ranks, ncols, padded):
    assert kron_cols(in_ranks) == ncols
    assert cols_padded(ncols) == padded


# Core ranks (100, 8, 100) at the default plan geometry: mode 1's input ranks
# sum to 200, so the staged lanes of 256 slots do not fit beside the output
# tile in a CUDA thread block and the kernel takes fewer slots per step; the
# reference takes any ranks.
WIDE_CORE_RANKS = (100, 8, 100)


@pytest.fixture(scope="module")
def wide_tensor():
    return jax_synthetic_tensor((200, 200, 200), 5_000, seed=0, skew=0.8)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_matches_plan_ref_at_wide_ranks(wide_tensor, mode):
    """The plain version against the reference's plan oracle at core ranks
    (100, 8, 100), default geometry (800 or 10,000 output columns)."""
    st = wide_tensor
    ref, plan, in_ranks, facs = carried(st, mode, WIDE_CORE_RANKS, tiles={})
    ncols = kron_cols(in_ranks)
    got = ttmc_blocked_plain(plan, factors_from_numpy(facs, "cpu"), in_ranks).numpy()
    assert got.shape == (ref.out_rows, cols_padded(ncols))
    assert_cols_close(got[:, :ncols],
                      jax_ttmc_plan_ref(ref, [jnp.asarray(f) for f in facs], in_ranks))
    assert not got[:, ncols:].any()


# tile_i = 8,192: more rows than the card's kernel keeps counts for in one
# thread block, so it splits the tile into row parts; the reference takes
# any tile_i.
BIG_TILES = dict(TILES, tile_i=8192)


@pytest.mark.parametrize("fixture,ranks", [("tiny_tensor", "mixed"), ("tensor4d", "mixed"),
                                           ("tensor5d", "equal")])
def test_plain_matches_pallas_interpret_at_tile_i_8192(request, fixture, ranks):
    """Every mode at tile_i = 8,192: the port builds the reference's plan bit
    for bit, and its plain version on that plan matches the interpret-mode
    Pallas kernel on the same numpy factors; padded lanes and rows zero."""
    st = request.getfixturevalue(fixture)
    core_ranks = CORE_RANKS[fixture][ranks]
    for mode in range(st.nmodes):
        ref, _, in_ranks, facs = carried(st, mode, core_ranks, tiles=BIG_TILES)
        plan = plan_blocks(SparseTensor(st.indices, st.values, st.shape), mode, device="cpu", **BIG_TILES)
        assert_plans_equal(ref, plan)
        ncols = kron_cols(in_ranks)
        got = ttmc_blocked_plain(plan, factors_from_numpy(facs, "cpu"), in_ranks).numpy()
        assert got.shape == (8192, cols_padded(ncols))
        assert_cols_close(got[:, :ncols], pallas_interpret(ref, facs, in_ranks))
        assert not got[:, ncols:].any()
        assert not got[st.shape[mode]:].any()
