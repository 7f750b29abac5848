"""Port parity for the host substrate: `repro_torch.core.coo` generators, the
Tensor Remapper's stream remaps (`pointer_table`, `remap_stable`,
`radix_digits`, `remap_radix`, `remap_pointer_machine`) and
`repro_torch.core.remap.plan_blocks` against the JAX package, bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hst

import jax.numpy as jnp

from repro.core import coo as jcoo
from repro.core import remap as jremap
from repro.core.remap import plan_blocks as jax_plan_blocks
from repro_torch.convert import plan_from_numpy
from repro_torch.core import coo as tcoo
from repro_torch.core.remap import (
    PlanValidationError,
    group_key,
    plan_blocks,
    plan_blocks_reference,
    pointer_table,
    radix_digits,
    remap_pointer_machine,
    remap_radix,
    remap_stable,
    validate_plan,
)


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


def assert_plans_equal(ref, plan):
    """Every BlockPlan field equal, arrays bit for bit and of the same dtype."""
    for name in ("vals", "iloc", "block_it"):
        a, b = getattr(ref, name), getattr(plan, name).cpu().numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("in_locs", "block_in"):
        xs, ys = getattr(ref, name), getattr(plan, name)
        assert len(xs) == len(ys), name
        for x, y in zip(xs, ys):
            assert x.dtype == y.cpu().numpy().dtype, name
            np.testing.assert_array_equal(x, y.cpu().numpy(), err_msg=name)
    for name in ("tile_i", "in_tiles", "blk", "out_rows", "in_rows", "mode", "in_modes", "nnz"):
        assert getattr(ref, name) == getattr(plan, name), name


@pytest.mark.parametrize("preset", ["tiny", "nell2_like", "4d_small", "5d_small"])
def test_frostt_like_identical(preset):
    """Same seed, same tensor: the port makes the reference's numpy calls."""
    a, b = jcoo.frostt_like(preset, seed=3), tcoo.frostt_like(preset, seed=3)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.shape == b.shape and a.indices.dtype == b.indices.dtype


@pytest.mark.parametrize("skew,dedup", [(0.0, False), (0.8, False), (1.1, True)])
def test_synthetic_tensor_identical(skew, dedup):
    a = jcoo.synthetic_tensor((30, 20, 25, 10), 900, seed=11, skew=skew, dedup=dedup)
    b = tcoo.synthetic_tensor((30, 20, 25, 10), 900, seed=11, skew=skew, dedup=dedup)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.values, b.values)
    assert tcoo.norm_sq(b) == float(np.sum(a.values.astype(np.float64) ** 2))


_TILES = [dict(), dict(tile_i=8, tile_j=16, tile_k=4, blk=16), dict(tile_i=7, tile_j=5, tile_k=3, blk=4)]


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
@pytest.mark.parametrize("tiles", _TILES, ids=["default", "small", "odd"])
def test_plan_blocks_bit_identical(request, fixture, tiles):
    """Every mode of a 3/4/5-mode tensor: the port's torch build equals the
    reference's numpy build in every field."""
    st = request.getfixturevalue(fixture)
    for mode in range(st.nmodes):
        ref = jax_plan_blocks(st, mode, **tiles)
        assert_plans_equal(ref, plan_blocks(to_port(st), mode, device="cpu", **tiles))


_PARITY_SHAPES = {3: (40, 30, 50), 4: (20, 15, 25, 10), 5: (12, 10, 14, 8, 9)}


@settings(max_examples=30, deadline=None)
@given(
    nmodes=hst.sampled_from([3, 4, 5]),
    nnz=hst.integers(1, 300),
    seed=hst.integers(0, 10_000),
    tiles=hst.sampled_from([(8, 8, 8, 16), (16, 8, 4, 8), (32, 16, 16, 32), (7, 5, 3, 4)]),
)
def test_plan_blocks_matches_jax_property(nmodes, nnz, seed, tiles):
    """Parity property over shapes, blk and tiles (mirrors the reference's
    vectorized-vs-loop property): the port's vectorized build and its loop
    reference both equal the JAX package's plan bit for bit."""
    shape = _PARITY_SHAPES[nmodes]
    mode = seed % nmodes
    st = tcoo.synthetic_tensor(shape, nnz, seed=seed, skew=0.7)
    ti, tj, tk, blk = tiles
    kw = dict(tile_i=ti, tile_j=tj, tile_k=tk, blk=blk)
    ref = jax_plan_blocks(jcoo.SparseTensor(st.indices, st.values, st.shape), mode, **kw)
    assert_plans_equal(ref, plan_blocks(st, mode, device="cpu", **kw))
    assert_plans_equal(ref, plan_blocks_reference(st, mode, device="cpu", **kw))


def test_plan_statistics_match_reference(tensor4d):
    ref = jax_plan_blocks(tensor4d, 1, tile_i=8, tile_j=16, tile_k=4, blk=16)
    plan = plan_blocks(to_port(tensor4d), 1, device="cpu", tile_i=8, tile_j=16, tile_k=4, blk=16)
    assert plan.padding_fraction() == ref.padding_fraction()
    assert plan.output_tile_runs() == ref.tile_fills()["A"]
    assert plan.a_tile_single_flush() and ref.a_tile_single_flush()


def test_plan_from_numpy_round_trip(tiny_tensor):
    """A reference plan carried over by convert.py is the port's plan."""
    ref = jax_plan_blocks(tiny_tensor, 2, tile_i=8, tile_j=16, tile_k=4, blk=16)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    carried = plan_from_numpy(fields, "cpu")
    assert_plans_equal(ref, carried)
    validate_plan(carried)


def test_validate_plan_names_violations(tiny_tensor):
    plan = plan_blocks(to_port(tiny_tensor), 0, device="cpu", tile_i=8, tile_j=16, tile_k=4, blk=16)
    assert validate_plan(plan) is plan
    bad = dataclasses.replace(plan, iloc=plan.iloc.clone())
    bad.iloc[0] = plan.tile_i
    with pytest.raises(PlanValidationError, match="iloc out of tile bounds"):
        validate_plan(bad)
    bad = dataclasses.replace(plan, block_it=plan.block_it.clone())
    bad.block_it[0] = plan.block_it[-1]  # the last tile's run now also starts the stream
    with pytest.raises(PlanValidationError, match="contiguity"):
        validate_plan(bad)
    bad = dataclasses.replace(plan, nnz=0)
    with pytest.raises(PlanValidationError, match="exceed nnz"):
        validate_plan(bad)


@pytest.mark.parametrize("flag,validated", [("", False), ("1", True)])
def test_validate_plans_env_switch(tiny_tensor, monkeypatch, flag, validated):
    """Validation stays opt-in: REPRO_VALIDATE_PLANS=1 validates every plan
    at build time."""
    from repro_torch.core import remap

    seen = []
    monkeypatch.setattr(remap, "validate_plan", lambda p: seen.append(p) or p)
    monkeypatch.setenv("REPRO_VALIDATE_PLANS", flag)
    plan = plan_blocks(to_port(tiny_tensor), 1, device="cpu", tile_i=8, tile_j=16, tile_k=4, blk=16)
    assert seen == ([plan] if validated else [])


def test_group_key_overflow_and_order():
    cols = [torch.tensor([1, 0, 1]), torch.tensor([2, 3, 0])]
    assert group_key(cols, [2, 4]).tolist() == [6, 3, 4]
    with pytest.raises(OverflowError):
        group_key([torch.tensor([0])] * 3, [2**22] * 3)


# ---------------------------------------------------------------------------
# The stream remaps of the compute patterns
# ---------------------------------------------------------------------------

def torch_stream(st):
    return torch.from_numpy(st.indices), torch.from_numpy(st.values)


def assert_same_stream(got, want):
    """(indices, values, order) equal bit for bit, the order as int64."""
    for a, b in zip(got, want):
        a, b = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a), np.asarray(b)
        if a.dtype.kind == "i":
            a, b = a.astype(np.int64), b.astype(np.int64)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_remap_stable_and_pointer_table_match_reference(request, fixture):
    """Every mode: `remap_stable` gives the reference's stream and order (ties
    keep their stream order), `remap_pointer_machine` the same stream, and
    `pointer_table` the reference's offsets and counts."""
    st = request.getfixturevalue(fixture)
    idx, val = torch_stream(st)
    for mode in range(st.nmodes):
        want = jremap.remap_stable(jnp.asarray(st.indices), jnp.asarray(st.values), mode)
        got = remap_stable(idx, val, mode)
        assert_same_stream(got, want)
        machine = remap_pointer_machine(st.indices, st.values, mode, st.shape[mode])
        assert_same_stream(machine, want[:2])
        assert_same_stream(machine, jremap.remap_pointer_machine(st.indices, st.values, mode,
                                                                 st.shape[mode]))
        offsets, counts = pointer_table(idx[:, mode], st.shape[mode])
        w_off, w_cnt = jremap.pointer_table(jnp.asarray(st.indices[:, mode]), st.shape[mode])
        assert offsets.dtype == counts.dtype == torch.int32
        np.testing.assert_array_equal(offsets.numpy(), np.asarray(w_off))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(w_cnt))


@pytest.mark.parametrize("budget", [2, 4, 7, 64, 1000])
@pytest.mark.parametrize("nbins", [1, 4, 63, 64, 65, 4096, 4097, 10**6])
def test_radix_digits_matches_reference(budget, nbins):
    """Exact powers of the budget included (the float formula's off-by-one)."""
    assert radix_digits(nbins, budget) == jremap.radix_digits(nbins, budget)
    assert budget ** radix_digits(nbins, budget) >= nbins
    assert radix_digits(nbins, budget) == 1 or budget ** (radix_digits(nbins, budget) - 1) < nbins


def test_radix_digits_rejects_one_bin():
    with pytest.raises(ValueError, match="two bins"):
        radix_digits(8, 1)


@pytest.mark.parametrize("budget", [2, 4, 7, 16, 4096])
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_remap_radix_equals_stable(request, fixture, budget):
    """Passes of at most `budget` bins give `remap_stable`'s stream and
    order, and the reference's `remap_radix`."""
    st = request.getfixturevalue(fixture)
    idx, val = torch_stream(st)
    for mode in range(st.nmodes):
        want = remap_stable(idx, val, mode)
        got = remap_radix(idx, val, mode, st.shape[mode], budget)
        assert_same_stream(got, want)
        assert_same_stream(got, jremap.remap_radix(jnp.asarray(st.indices), jnp.asarray(st.values),
                                                   mode, st.shape[mode], budget))


@pytest.mark.parametrize("budget,power", [(2, 6), (4, 3), (8, 2), (16, 2)])
def test_remap_radix_at_exact_powers_of_the_budget(budget, power):
    """nbins = budget ** power: exactly `power` passes, and the coordinate
    nbins - 1 (every digit at its largest) sorts last."""
    nbins = budget ** power
    rng = np.random.default_rng(nbins)
    coords = rng.integers(0, nbins, 3_000).astype(np.int32)
    coords[:3] = nbins - 1
    coords[3:6] = 0
    idx = torch.from_numpy(np.stack([coords, coords[::-1].copy(), coords % 5], axis=1))
    val = torch.from_numpy(rng.standard_normal(3_000).astype(np.float32))
    assert radix_digits(nbins, budget) == power
    got = remap_radix(idx, val, 0, nbins, budget)
    assert_same_stream(got, remap_stable(idx, val, 0))
    assert int(got[0][-1, 0]) == nbins - 1


@settings(max_examples=20, deadline=None)
@given(nnz=hst.integers(1, 400), nbins=hst.integers(1, 300), budget=hst.integers(2, 40),
       seed=hst.integers(0, 2**31 - 1))
def test_remap_radix_property(nnz, nbins, budget, seed):
    """Any stream with many ties: radix passes and the stable sort agree,
    and both give the reference's order."""
    rng = np.random.default_rng(seed)
    ind = rng.integers(0, nbins, (nnz, 3)).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    idx, val = torch.from_numpy(ind), torch.from_numpy(vals)
    stable = remap_stable(idx, val, 1)
    assert_same_stream(remap_radix(idx, val, 1, nbins, budget), stable)
    assert_same_stream(stable, jremap.remap_stable(jnp.asarray(ind), jnp.asarray(vals), 1))


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_sorted_by_and_nbytes_match_reference(request, fixture):
    st = request.getfixturevalue(fixture)
    port = to_port(st)
    assert port.nbytes() == st.nbytes() and port.nbytes(8, 8) == st.nbytes(8, 8)
    for mode in range(st.nmodes):
        got, want = port.sorted_by(mode), st.sorted_by(mode)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.values, want.values)
        assert got.is_sorted_by(mode) and want.is_sorted_by(mode)
        assert port.is_sorted_by(mode) == st.is_sorted_by(mode)
