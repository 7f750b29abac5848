"""Port parity for the module that holds the MTTKRP kernel
(`repro_torch.kernels.mttkrp`): its plain version against the reference's
Pallas kernel (interpret mode, as the reference's own tests run it) and the
reference's plan oracle, on the same plans and padded factors, carried over
by `repro_torch.convert`.  On the CPU the wrapper takes the plain version.
Also the paper's two compute patterns (`repro_torch.core.mttkrp`) and the
dense cross-check against the reference's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coo import frostt_like as jax_frostt_like
from repro.core.mttkrp import mttkrp as jax_mttkrp
from repro.core.mttkrp import mttkrp_approach1 as jax_mttkrp_approach1
from repro.core.remap import plan_blocks as jax_plan_blocks
from repro.kernels.mttkrp_pallas import mttkrp_pallas_call
from repro.kernels.ref import mttkrp_plan_ref as jax_mttkrp_plan_ref
from repro.kernels.ref import mttkrp_ref_dense as jax_mttkrp_ref_dense
from repro.kernels.workspace import _visited_row_mask
from repro_torch.convert import factors_from_numpy, plan_from_numpy
from repro_torch.core import coo as tcoo
from repro_torch.core.coo import SparseTensor
import repro_torch.core.mttkrp as tmttkrp
from repro_torch.core.mttkrp import mttkrp, mttkrp_approach1, mttkrp_approach2
from repro_torch.core.remap import remap_stable
from repro_torch.core.remap import plan_blocks
from repro_torch.kernels.mttkrp import (
    mttkrp_blocked,
    mttkrp_blocked_plain,
    pad_factor,
    rank_padded,
)
from repro_torch.kernels.ops import make_planned_mttkrp
from repro_torch.kernels.ref import mttkrp_plan_ref, mttkrp_ref, mttkrp_ref_dense
from test_torch_remap import assert_plans_equal

RANK = 4
# float32 sums over the same terms taken in another order (the Pallas
# kernel's one-hot matmul vs index_add_).
RTOL = ATOL = 1e-5
TILES = dict(tile_i=8, tile_j=16, tile_k=4, blk=16)


def carried(st, mode, tiles=TILES):
    """The reference plan (small tiles, or `tiles`), the same plan in the
    port, and padded factors (numpy, made from a seed) for its input modes."""
    ref = jax_plan_blocks(st, mode, **tiles)
    plan = plan_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}, "cpu")
    rng = np.random.default_rng(100 + mode)
    rp = rank_padded(RANK)
    facs = []
    for rows, m in zip(ref.in_rows, ref.in_modes):
        f = np.zeros((rows, rp), np.float32)
        f[: st.shape[m], :RANK] = rng.standard_normal((st.shape[m], RANK))
        facs.append(f)
    return ref, plan, facs


def pallas_interpret(ref, facs):
    nb, blk = ref.nblocks, ref.blk
    out = mttkrp_pallas_call(
        jnp.asarray(ref.block_it),
        [jnp.asarray(t) for t in ref.block_in],
        jnp.asarray(ref.vals).reshape(nb, blk),
        jnp.asarray(ref.iloc).reshape(nb, blk),
        [jnp.asarray(l).reshape(nb, blk) for l in ref.in_locs],
        [jnp.asarray(f) for f in facs],
        tile_i=ref.tile_i, in_tiles=ref.in_tiles, blk=blk, out_rows=ref.out_rows,
        interpret=True,
    )
    mask = _visited_row_mask(ref.block_it, ref.tile_i, ref.out_rows)
    return np.where(mask[:, None] > 0, np.asarray(out), 0.0)


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_plain_matches_pallas_interpret_and_plan_ref(request, fixture):
    """Every mode of a 3/4/5-mode tensor (n_in = 2, 3, 4)."""
    st = request.getfixturevalue(fixture)
    for mode in range(st.nmodes):
        ref, plan, facs = carried(st, mode)
        got = mttkrp_blocked_plain(plan, factors_from_numpy(facs, "cpu")).numpy()
        assert got.shape == (ref.out_rows, rank_padded(RANK))
        np.testing.assert_allclose(got, pallas_interpret(ref, facs), rtol=RTOL, atol=ATOL)
        want = np.asarray(jax_mttkrp_plan_ref(ref, [jnp.asarray(f) for f in facs], rank_padded(RANK)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        # padded lanes and rows no non-zero reaches stay exactly zero
        assert not got[:, RANK:].any()
        assert not got[st.shape[mode]:].any()


def test_wrapper_on_cpu_takes_plain_version(tensor4d):
    """CPU tensors run the plain version and launch nothing."""
    before = mttkrp_blocked.launches
    ref, plan, facs = carried(tensor4d, 2)
    tf = factors_from_numpy(facs, "cpu")
    torch.testing.assert_close(mttkrp_blocked(plan, tf), mttkrp_blocked_plain(plan, tf), rtol=0, atol=0)
    torch.testing.assert_close(mttkrp_blocked(plan, tf), mttkrp_plan_ref(plan, tf), rtol=RTOL, atol=ATOL)
    assert mttkrp_blocked.launches == before == 0


def test_plain_chunking_is_exact(tiny_tensor, monkeypatch):
    """The plain version's block-aligned chunks add up to the unchunked sum."""
    from repro_torch.kernels import mttkrp as module

    _, plan, facs = carried(tiny_tensor, 0)
    tf = factors_from_numpy(facs, "cpu")
    whole = mttkrp_blocked_plain(plan, tf)
    monkeypatch.setattr(module, "PLAIN_CHUNK", 3 * plan.blk)
    torch.testing.assert_close(mttkrp_blocked_plain(plan, tf), whole, rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_what_the_kernel_does_not_take(tiny_tensor):
    _, plan, facs = carried(tiny_tensor, 1)
    tf = factors_from_numpy(facs, "cpu")
    with pytest.raises(ValueError, match="factors for"):
        mttkrp_blocked(plan, tf[:1])
    with pytest.raises(ValueError, match="float32"):
        mttkrp_blocked(plan, [tf[0].double(), tf[1]])
    with pytest.raises(ValueError, match="factor 1"):
        mttkrp_blocked(plan, [tf[0], tf[1][:, :2].contiguous()])
    with pytest.raises(ValueError, match=r">= \d+"):
        mttkrp_blocked(plan, [tf[0][:1], tf[1]])
    with pytest.raises(ValueError, match="contiguous"):
        mttkrp_blocked(plan, [tf[0], tf[1].t().contiguous().t()])
    with pytest.raises(ValueError, match="plan.iloc"):
        mttkrp_blocked(dataclasses.replace(plan, iloc=plan.iloc.long()), tf)


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_planned_mttkrp_matches_raw_stream(request, fixture):
    """`PlannedMTTKRP` (plan built by the port, true-shape factors in, rank
    columns out) against gather/index_add_ on the raw COO stream."""
    st = request.getfixturevalue(fixture)
    pst = SparseTensor(st.indices, st.values, st.shape)
    rng = np.random.default_rng(3)
    facs = factors_from_numpy([rng.standard_normal((s, 5)).astype(np.float32) for s in st.shape], "cpu")
    idx, val = torch.from_numpy(st.indices), torch.from_numpy(st.values)
    for mode in range(st.nmodes):
        op = make_planned_mttkrp(pst, mode, 5, device="cpu")
        got = op(*(facs[m] for m in op.plan.in_modes))
        assert got.shape == (op.plan.out_rows, 5)
        want = mttkrp_ref(idx, val, facs, mode, op.plan.out_rows)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rank,rp", [(1, 4), (4, 4), (5, 8), (16, 16)])
def test_rank_padding(rank, rp):
    assert rank_padded(rank) == rp
    f = torch.arange(3.0 * rank).reshape(3, rank)
    p = pad_factor(f, 8, rp)
    assert p.shape == (8, rp) and torch.equal(p[:3, :rank], f)
    assert not p[3:].any() and not p[:, rank:].any()


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor5d"])
def test_approach1_matches_reference(request, fixture):
    st = request.getfixturevalue(fixture)
    rng = np.random.default_rng(7)
    facs = [rng.standard_normal((s, RANK)).astype(np.float32) for s in st.shape]
    for mode in range(st.nmodes):
        want = np.asarray(jax_mttkrp_approach1(
            jnp.asarray(st.indices), jnp.asarray(st.values), [jnp.asarray(f) for f in facs],
            mode, st.shape[mode], sorted_by_mode=False))
        got = mttkrp_approach1(torch.from_numpy(st.indices), torch.from_numpy(st.values),
                               factors_from_numpy(facs, "cpu"), mode, st.shape[mode],
                               sorted_by_mode=False)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def pattern_inputs(st, mode, seed=11):
    """The stream sorted by `mode` (numpy and torch) and numpy factors."""
    s = st.sorted_by(mode)
    rng = np.random.default_rng(seed + mode)
    facs = [rng.standard_normal((n, RANK)).astype(np.float32) for n in st.shape]
    return s, facs


@pytest.mark.parametrize("method", ["approach1", "approach2"])
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_compute_patterns_match_reference(request, fixture, method):
    """Every mode on the stream sorted by it: the port's approach and its
    `mttkrp` dispatcher against the reference's, to 1e-5."""
    st = request.getfixturevalue(fixture)
    for mode in range(st.nmodes):
        s, facs = pattern_inputs(st, mode)
        want = np.asarray(jax_mttkrp(jnp.asarray(s.indices), jnp.asarray(s.values),
                                         [jnp.asarray(f) for f in facs], mode, st.shape[mode],
                                         method=method))
        args = (torch.from_numpy(s.indices), torch.from_numpy(s.values),
                factors_from_numpy(facs, "cpu"), mode, st.shape[mode])
        direct = (mttkrp_approach1 if method == "approach1" else mttkrp_approach2)(*args)
        np.testing.assert_allclose(direct.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(mttkrp(*args, method=method).numpy(), want, rtol=RTOL, atol=ATOL)


def test_approach1_on_an_unsorted_stream(tiny_tensor):
    """sorted_by_mode=False takes the general path (the reference's unsorted
    segment_sum); a sorted-only reduction refuses an unsorted stream rather
    than summing the wrong slots."""
    st = tiny_tensor
    assert not st.is_sorted_by(0)
    rng = np.random.default_rng(3)
    facs = [rng.standard_normal((n, RANK)).astype(np.float32) for n in st.shape]
    idx, val = torch.from_numpy(st.indices), torch.from_numpy(st.values)
    want = np.asarray(jax_mttkrp_approach1(jnp.asarray(st.indices), jnp.asarray(st.values),
                                           [jnp.asarray(f) for f in facs], 0, st.shape[0],
                                           sorted_by_mode=False))
    got = mttkrp(idx, val, factors_from_numpy(facs, "cpu"), 0, st.shape[0], sorted_by_mode=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="not sorted"):
        mttkrp(idx, val, factors_from_numpy(facs, "cpu"), 0, st.shape[0])
    s_idx, s_val, _ = remap_stable(idx, val, 0)
    np.testing.assert_allclose(mttkrp(s_idx, s_val, factors_from_numpy(facs, "cpu"), 0,
                                      st.shape[0]).numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("segment", [2, 3, 16])
def test_approach1_sums_hot_rows_in_levels(monkeypatch, segment):
    """Runs longer than a segment (a zipf-3 tensor's hot rows) are summed
    over several levels of segments and give the scatter-add's sums; empty
    output rows stay 0."""
    monkeypatch.setattr(tmttkrp, "SEGMENT", segment)
    st = tcoo.synthetic_tensor((300, 40, 50), 3_000, seed=1, skew=3.0).sorted_by(0)
    rng = np.random.default_rng(segment)
    facs = [torch.from_numpy(rng.standard_normal((n, RANK)).astype(np.float32)) for n in st.shape]
    idx, val = torch.from_numpy(st.indices), torch.from_numpy(st.values)
    got = mttkrp_approach1(idx, val, facs, 0, 320)
    want = mttkrp_approach2(idx, val, facs, 0, 320)
    assert got.shape == (320, RANK) and not got[300:].any()
    assert int(np.bincount(st.indices[:, 0]).max()) > segment ** 2
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_mttkrp_ref_dense_matches_reference(tiny_tensor, mode):
    """The dense cross-check against the reference's, and the raw-stream
    reference against both."""
    st = tiny_tensor
    rng = np.random.default_rng(20 + mode)
    facs = [rng.standard_normal((n, RANK)).astype(np.float32) for n in st.shape]
    got = mttkrp_ref_dense(st.indices, st.values, facs, mode, st.shape[mode])
    want = jax_mttkrp_ref_dense(st.indices, st.values, facs, mode, st.shape[mode])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    stream = mttkrp_ref(torch.from_numpy(st.indices), torch.from_numpy(st.values),
                        factors_from_numpy(facs, "cpu"), mode, st.shape[mode])
    np.testing.assert_allclose(stream.numpy(), got, rtol=RTOL, atol=ATOL)


def test_compute_pattern_contracts(tiny_tensor):
    st = tiny_tensor
    idx, val = torch.from_numpy(st.indices), torch.from_numpy(st.values)
    facs = [torch.ones((n, RANK)) for n in st.shape]
    with pytest.raises(ValueError, match="unknown method"):
        mttkrp(idx, val, facs, 0, st.shape[0], method="pallas")
    with pytest.raises(ValueError, match="two modes|3 modes"):
        mttkrp_ref_dense(st.indices[:, :2], st.values, [f.numpy() for f in facs[:2]], 0, 64)
    empty = mttkrp_approach1(idx[:0], val[:0], facs, 1, st.shape[1])
    assert empty.shape == (st.shape[1], RANK) and not empty.any()


# CP rank 256 at the default plan geometry (tile_i = 256): the CUDA kernel
# takes rows this wide in column slices; the reference takes any rank.
WIDE_RANK = 256


def assert_cols_close(got, want, tol=1e-5):
    """Largest error relative to each output column's max: float32 sums over
    the same terms in another order."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    err = (np.abs(got - want).max(axis=0) / scale).max()
    assert err <= tol, err


@pytest.mark.parametrize("preset", ["tiny", "4d_small", "5d_small"])
def test_plain_matches_plan_ref_at_rank_256(preset):
    """Every mode of the 3/4/5-mode presets at CP rank 256, default geometry:
    the plain version against the reference's plan oracle on the same plan
    and padded factors."""
    st = jax_frostt_like(preset)
    rng = np.random.default_rng(256)
    for mode in range(st.nmodes):
        ref = jax_plan_blocks(st, mode)
        plan = plan_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}, "cpu")
        facs = []
        for rows, m in zip(ref.in_rows, ref.in_modes):
            f = np.zeros((rows, WIDE_RANK), np.float32)
            f[: st.shape[m]] = rng.standard_normal((st.shape[m], WIDE_RANK))
            facs.append(f)
        got = mttkrp_blocked_plain(plan, factors_from_numpy(facs, "cpu")).numpy()
        want = np.asarray(jax_mttkrp_plan_ref(ref, [jnp.asarray(f) for f in facs], WIDE_RANK))
        assert_cols_close(got, want)
        assert not got[st.shape[mode]:].any()


# tile_i = 8,192: more rows than a CUDA thread block holds in one rank-16
# output tile, so the card's kernel splits the tile into row parts; the
# reference takes any tile_i.
BIG_TILES = dict(TILES, tile_i=8192)


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d"])
def test_plain_matches_pallas_interpret_at_tile_i_8192(request, fixture):
    """Every mode at tile_i = 8,192: the port builds the reference's plan bit
    for bit, and its plain version on that plan matches the interpret-mode
    Pallas kernel on the same numpy factors."""
    st = request.getfixturevalue(fixture)
    for mode in range(st.nmodes):
        ref, _, facs = carried(st, mode, BIG_TILES)
        plan = plan_blocks(SparseTensor(st.indices, st.values, st.shape), mode, device="cpu", **BIG_TILES)
        assert_plans_equal(ref, plan)
        got = mttkrp_blocked_plain(plan, factors_from_numpy(facs, "cpu")).numpy()
        assert got.shape == (8192, rank_padded(RANK))
        np.testing.assert_allclose(got, pallas_interpret(ref, facs), rtol=RTOL, atol=ATOL)
        assert not got[:, RANK:].any()
        assert not got[st.shape[mode]:].any()
