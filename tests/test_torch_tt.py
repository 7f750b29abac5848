"""Port parity for the module that holds the TT-core kernel
(`repro_torch.kernels.tt`): its plain version against the reference's
Pallas kernel (interpret mode, as the reference's own tests run it) and the
reference's oracles, on the same plans and padded interface matrices,
carried over by `repro_torch.convert`; on every mode of 3/4/5-mode tensors
with equal and mixed TT ranks.  On the CPU the wrapper takes the plain
version."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coo import synthetic_tensor as jax_synthetic_tensor
from repro.core.remap import plan_blocks as jax_plan_blocks
from repro.kernels.ref import ttcore_plan_ref as jax_ttcore_plan_ref
from repro.kernels.ref import ttcore_ref as jax_ttcore_ref
from repro.kernels.ref import ttcore_ref_dense as jax_ttcore_ref_dense
from repro.kernels.tt_pallas import ttcore_pallas_call
from repro.kernels.workspace import _visited_row_mask
from repro_torch.convert import cores_from_numpy, factors_from_numpy, plan_from_numpy
from repro_torch.core.coo import SparseTensor
from repro_torch.kernels.mttkrp import rank_padded
from repro_torch.kernels.ops import _tt_bond_pairs, make_planned_ttcore
import repro_torch.kernels.ref as ref_module
from repro_torch.kernels.ref import ttcore_plan_ref, ttcore_ref, ttcore_ref_dense
from repro_torch.kernels.tt import tt_out_cols, tt_out_pair, ttcore_blocked, ttcore_blocked_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# Largest error allowed relative to each output column's max: float32 sums
# over the same terms taken in another order (the Pallas kernel's one-hot
# matmul, einsum and bmm chains, index_add_).
COL_TOL = 1e-5
TILES = dict(tile_i=8, tile_j=16, tile_k=4, blk=16)
# Equal TT ranks, and mixed ones: equal ranks would hide a transposed
# (rl, rr) lane order or a chain run in the wrong direction.
TT_RANKS = {
    "tiny_tensor": {"equal": (3, 3), "mixed": (3, 5)},
    "tensor4d": {"equal": (3, 3, 3), "mixed": (4, 3, 5)},
    "tensor5d": {"equal": (2, 2, 2, 2), "mixed": (2, 4, 3, 2)},
}
CASES = [(f, k) for f in TT_RANKS for k in ("equal", "mixed")]


def assert_cols_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    err = (np.abs(got - want).max(axis=0) / scale).max()
    assert err <= COL_TOL, err


def random_cores(shape, tt_ranks, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rl, s, rr)).astype(np.float32)
            for s, (rl, rr) in zip(shape, _tt_bond_pairs(tt_ranks, len(shape)))]


def carried(st, mode, tt_ranks, seed=0, tiles=TILES):
    """The reference plan (small tiles, or `tiles`; {} for the default
    geometry), the same plan in the port, the input bond pairs, and padded
    interface matrices (numpy, made from a seed) for its input modes."""
    ref = jax_plan_blocks(st, mode, **tiles)
    plan = plan_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}, "cpu")
    pairs = _tt_bond_pairs(tt_ranks, st.nmodes)
    in_pairs = tuple(pairs[m] for m in ref.in_modes)
    rng = np.random.default_rng(100 * seed + mode)
    mats = []
    for rows, m, (a, b) in zip(ref.in_rows, ref.in_modes, in_pairs):
        w = np.zeros((rows, rank_padded(a * b)), np.float32)
        w[: st.shape[m], : a * b] = rng.standard_normal((st.shape[m], a * b))
        mats.append(w)
    return ref, plan, in_pairs, mats


def pallas_interpret(ref, mats, in_pairs):
    nb, blk = ref.nblocks, ref.blk
    out = ttcore_pallas_call(
        jnp.asarray(ref.block_it),
        [jnp.asarray(t) for t in ref.block_in],
        jnp.asarray(ref.vals).reshape(nb, blk),
        jnp.asarray(ref.iloc).reshape(nb, blk),
        [jnp.asarray(l).reshape(nb, blk) for l in ref.in_locs],
        [jnp.asarray(w) for w in mats],
        tile_i=ref.tile_i, in_tiles=ref.in_tiles, in_rank_pairs=in_pairs, n_left=ref.mode,
        blk=blk, out_rows=ref.out_rows, interpret=True,
    )
    mask = _visited_row_mask(ref.block_it, ref.tile_i, ref.out_rows)
    return np.where(mask[:, None] > 0, np.asarray(out), 0.0)[:, : tt_out_cols(in_pairs, ref.mode)]


@pytest.mark.parametrize("fixture,ranks", CASES)
def test_plain_matches_pallas_interpret_and_plan_refs(request, fixture, ranks):
    """Every mode: the plain version vs the interpret-mode Pallas kernel and
    both packages' plan oracles; padded lanes and rows exactly zero."""
    st = request.getfixturevalue(fixture)
    tt_ranks = TT_RANKS[fixture][ranks]
    for mode in range(st.nmodes):
        ref, plan, in_pairs, mats = carried(st, mode, tt_ranks)
        ncols = tt_out_cols(in_pairs, mode)
        got = ttcore_blocked_plain(plan, factors_from_numpy(mats, "cpu"), in_pairs, mode).numpy()
        assert got.shape == (ref.out_rows, rank_padded(ncols))
        assert_cols_close(got[:, :ncols], pallas_interpret(ref, mats, in_pairs))
        assert_cols_close(got[:, :ncols],
                          jax_ttcore_plan_ref(ref, [jnp.asarray(w) for w in mats], in_pairs, mode))
        assert_cols_close(got[:, :ncols],
                          ttcore_plan_ref(plan, factors_from_numpy(mats, "cpu"), in_pairs, mode))
        assert not got[:, ncols:].any()
        assert not got[st.shape[mode]:].any()


@pytest.mark.parametrize("fixture,ranks", CASES)
def test_planned_ttcore_matches_raw_stream_refs(request, fixture, ranks):
    """`PlannedTTCore` (plan built by the port, default geometry, true-shape
    interface matrices in) against `ttcore_ref` on the raw COO stream, in
    both packages, and against both packages' dense cross-checks."""
    st = request.getfixturevalue(fixture)
    tt_ranks = TT_RANKS[fixture][ranks]
    pst = SparseTensor(st.indices, st.values, st.shape)
    np_cores = random_cores(st.shape, tt_ranks, seed=3)
    cores = cores_from_numpy(np_cores, "cpu")
    mats = [c.permute(1, 0, 2).reshape(c.shape[1], -1) for c in cores]
    idx, val = torch.from_numpy(st.indices), torch.from_numpy(st.values)
    for mode in range(st.nmodes):
        op = make_planned_ttcore(pst, mode, tt_ranks, device="cpu")
        assert op.n_left == mode
        got = op.output(mats, st.shape[mode])
        assert got.shape == (st.shape[mode], op.out_cols)
        want = np.asarray(jax_ttcore_ref(jnp.asarray(st.indices), jnp.asarray(st.values),
                                         [jnp.asarray(c) for c in np_cores], mode, st.shape[mode]))
        assert_cols_close(got, want)
        assert_cols_close(ttcore_ref(idx, val, cores, mode, st.shape[mode]), want)
        dense = jax_ttcore_ref_dense(st.indices, st.values, np_cores, mode, st.shape[mode])
        assert_cols_close(ttcore_ref_dense(idx, val, cores, mode, st.shape[mode]), dense)
        assert_cols_close(ttcore_ref(idx, val, cores, mode, st.shape[mode]), dense)


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_ttcore_ref_chunks_equal_one_step(request, fixture, monkeypatch):
    """`ttcore_ref` in steps of fewer non-zeros than the stream holds equals
    the same sum in one step: the reference's unchunked form, which
    `test_planned_ttcore_matches_raw_stream_refs` holds to the reference's
    `ttcore_ref`."""
    st = request.getfixturevalue(fixture)
    tt_ranks = TT_RANKS[fixture]["mixed"]
    np_cores = random_cores(st.shape, tt_ranks, seed=8)
    cores = cores_from_numpy(np_cores, "cpu")
    idx, val = torch.from_numpy(st.indices), torch.from_numpy(st.values)
    for mode in range(st.nmodes):
        monkeypatch.setattr(ref_module, "REF_ELEMS", 1 << 40)  # one step
        whole = ttcore_ref(idx, val, cores, mode, st.shape[mode])
        monkeypatch.setattr(ref_module, "REF_ELEMS", 97 * 12)  # steps of fewer than nnz
        torch.testing.assert_close(ttcore_ref(idx, val, cores, mode, st.shape[mode]), whole,
                                   rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_takes_plain_version(tensor4d):
    """CPU tensors run the plain version and launch nothing."""
    before = ttcore_blocked.launches
    _, plan, in_pairs, mats = carried(tensor4d, 2, (4, 3, 5))
    tm = factors_from_numpy(mats, "cpu")
    torch.testing.assert_close(ttcore_blocked(plan, tm, in_pairs, 2),
                               ttcore_blocked_plain(plan, tm, in_pairs, 2), rtol=0, atol=0)
    assert ttcore_blocked.launches == before == 0


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_chunking_is_exact(tiny_tensor, monkeypatch, mode):
    """The plain version's block-aligned steps add up to the one-step sum,
    also when a step is smaller than one block's slot-lanes."""
    from repro_torch.kernels import tt as module

    _, plan, in_pairs, mats = carried(tiny_tensor, mode, (3, 5))
    tm = factors_from_numpy(mats, "cpu")
    whole = ttcore_blocked_plain(plan, tm, in_pairs, mode)
    for elems in (3 * plan.blk * 15, 1):
        monkeypatch.setattr(module, "PLAIN_ELEMS", elems)
        assert_cols_close(ttcore_blocked_plain(plan, tm, in_pairs, mode), whole)


def test_float64_plain_version(tiny_tensor):
    """Inputs cast up give a float64 result within float32 rounding of the
    float32 one (the reference that chip_smoke.py holds the kernel to)."""
    _, plan, in_pairs, mats = carried(tiny_tensor, 1, (3, 5))
    tm = factors_from_numpy(mats, "cpu")
    f64 = ttcore_blocked_plain(dataclasses.replace(plan, vals=plan.vals.double()),
                               [w.double() for w in tm], in_pairs, 1)
    assert f64.dtype == torch.float64
    assert_cols_close(ttcore_blocked_plain(plan, tm, in_pairs, 1), f64)


@pytest.mark.parametrize("pairs,n_left,pair,cols", [
    (((3, 5), (5, 1)), 0, (1, 3), 3),
    (((1, 3), (5, 1)), 1, (3, 5), 15),
    (((1, 3), (3, 5)), 2, (5, 1), 5),
    (((1, 16), (16, 1)), 1, (16, 16), 256),
    (((1, 2), (2, 4), (3, 2)), 2, (4, 3), 12),
])
def test_tt_out_pair_and_cols(pairs, n_left, pair, cols):
    assert tt_out_pair(pairs, n_left) == pair
    assert tt_out_cols(pairs, n_left) == cols


def test_ttcore_rejects_bad_pairs(tiny_tensor):
    _, plan, in_pairs, mats = carried(tiny_tensor, 1, (3, 5))
    tm = factors_from_numpy(mats, "cpu")
    with pytest.raises(ValueError, match="in_rank_pairs"):
        ttcore_blocked(plan, tm, in_pairs[:1], 1)
    with pytest.raises(ValueError, match="in_rank_pairs"):
        ttcore_blocked(plan, tm, ((1, 3), (0, 1)), 1)
    with pytest.raises(ValueError, match="do not chain"):
        ttcore_blocked(plan, tm, ((2, 3), (5, 1)), 1)  # the left chain starts at bond 1
    with pytest.raises(ValueError, match="do not chain"):
        ttcore_blocked(plan, tm, ((1, 3), (5, 2)), 1)  # the right chain ends at bond 1
    with pytest.raises(ValueError, match="n_left"):
        ttcore_blocked(plan, tm, in_pairs, 3)
    with pytest.raises(ValueError, match="factor 1"):
        ttcore_blocked(plan, tm, ((1, 3), (9, 1)), 1)  # wider than matrix 1's 8 lanes


def test_bond_pairs():
    assert _tt_bond_pairs((3, 5), 3) == ((1, 3), (3, 5), (5, 1))
    assert _tt_bond_pairs((2, 4, 3, 2), 5) == ((1, 2), (2, 4), (4, 3), (3, 2), (2, 1))
    with pytest.raises(ValueError, match="N-1 interior"):
        _tt_bond_pairs((3, 5, 2), 3)


# Bonds at the default plan geometry that the CUDA kernel takes only since it
# sizes its steps at launch: 17-32, above 32, and (100, 100), whose middle
# core's interface rows hold 10,000 floats.  The reference takes them all.
WIDE_TT = {"tiny_24_24": ("tiny_tensor", (24, 24)), "tiny_40_48": ("tiny_tensor", (40, 48)),
           "wide_100_100": ("wide_tensor", (100, 100))}


@pytest.fixture(scope="module")
def wide_tensor():
    return jax_synthetic_tensor((200, 200, 200), 5_000, seed=0, skew=0.8)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(WIDE_TT))
def test_plain_matches_plan_refs_at_wide_bonds(request, case, mode):
    """The plain version against both packages' plan oracles, default
    geometry; padded lanes and rows exactly zero."""
    fixture, tt_ranks = WIDE_TT[case]
    st = request.getfixturevalue(fixture)
    ref, plan, in_pairs, mats = carried(st, mode, tt_ranks, tiles={})
    ncols = tt_out_cols(in_pairs, mode)
    tm = factors_from_numpy(mats, "cpu")
    got = ttcore_blocked_plain(plan, tm, in_pairs, mode).numpy()
    assert got.shape == (ref.out_rows, rank_padded(ncols))
    assert_cols_close(got[:, :ncols],
                      jax_ttcore_plan_ref(ref, [jnp.asarray(w) for w in mats], in_pairs, mode))
    assert_cols_close(got[:, :ncols], ttcore_plan_ref(plan, tm, in_pairs, mode))
    assert not got[:, ncols:].any()
    assert not got[st.shape[mode]:].any()
