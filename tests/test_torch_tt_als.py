"""The TT slice as a whole: `repro_torch.api.decompose(format="tt")` against
`repro.api.decompose(format="tt", method="pallas")` on 3/4/5-mode tensors,
from the TT-SVD init (the same cores in both packages) and from the
reference's own random cores; and the contracts of `tt_als` and its workspace.

Raw cores are not compared: a TT has a gauge freedom (G_k M, M^-1 G_{k+1}
give the same tensor), and the two packages' solves may move along it in
their last bits.  The fits and the model's values at the non-zeros are
compared instead."""
import jax
import numpy as np
import pytest
import torch

from repro.api import decompose as jax_decompose
from repro.tt import init_tt_cores as jax_init_tt_cores
from repro.tt import tt_svd as jax_tt_svd
import repro_torch.kernels.ops as ops_module
from repro_torch.api import decompose
from repro_torch.convert import cores_from_numpy, ttstate_to_numpy
from repro_torch.core import coo as tcoo
from repro_torch.tt import (
    TTState,
    core_to_matrix,
    init_tt_cores,
    make_planned_tt,
    matrix_to_core,
    tt_als,
    tt_fit_value,
    tt_inner,
    tt_norm_sq,
    tt_svd,
)
from repro_torch.tt.als import _TT_SVD_DENSE_LIMIT, _validated_tt_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ITERS = 3
FIT_TOL = 1e-5  # the ROADMAP's fit bar; float32 sums in another order
VALUE_TOL = 1e-4  # the model at the non-zeros, relative to its largest value
TT_RANKS = {"tiny_tensor": (4, 4), "tensor4d": (3, 3, 3), "tensor5d": (2, 2, 2, 2)}


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


def values_at_nonzeros(cores, indices) -> np.ndarray:
    """The TT model at each non-zero's coordinates, chained in float64."""
    v = np.ones((indices.shape[0], 1))
    for k, c in enumerate(cores):
        rows = np.asarray(c, np.float64).transpose(1, 0, 2)[indices[:, k]]
        v = np.einsum("za,zab->zb", v, rows)
    return v[:, 0]


def assert_same_model(got_cores, got_fits, want_cores, want_fits, indices):
    np.testing.assert_allclose(got_fits, want_fits, rtol=0, atol=FIT_TOL)
    got = values_at_nonzeros(got_cores, indices)
    want = values_at_nonzeros(want_cores, indices)
    assert np.abs(got - want).max() <= VALUE_TOL * np.abs(want).max()


@pytest.mark.parametrize("fixture", sorted(TT_RANKS))
def test_decompose_matches_reference(request, fixture):
    st = request.getfixturevalue(fixture)
    tt_ranks = TT_RANKS[fixture]
    ref = jax_decompose(st, tt_ranks, format="tt", method="pallas", iters=ITERS, init="svd")
    out = ttstate_to_numpy(decompose(to_port(st), tt_ranks, format="tt", iters=ITERS, init="svd",
                                     device="cpu"))
    assert len(out["fit_history"]) == ITERS
    assert [c.shape for c in out["cores"]] == [tuple(c.shape) for c in ref.cores]
    assert_same_model(out["cores"], out["fit_history"], ref.cores, ref.fit_history, st.indices)


@pytest.mark.parametrize("fixture", sorted(TT_RANKS))
def test_reference_method_matches_jax_reference(request, fixture):
    """method='reference' against the reference's method='reference', both
    from the TT-SVD init: fits to 1e-5 over 3 iterations, the model at the
    non-zeros to 1e-4."""
    st = request.getfixturevalue(fixture)
    tt_ranks = TT_RANKS[fixture]
    ref = jax_decompose(st, tt_ranks, format="tt", method="reference", iters=ITERS, init="svd")
    out = ttstate_to_numpy(decompose(to_port(st), tt_ranks, format="tt", method="reference",
                                     iters=ITERS, init="svd", device="cpu"))
    assert len(out["fit_history"]) == ITERS
    assert_same_model(out["cores"], out["fit_history"], ref.cores, ref.fit_history, st.indices)


def test_from_reference_random_cores(tiny_tensor):
    """The reference's random init (its `init_tt_cores` from PRNGKey(seed))
    passed in as initial cores gives the reference's run."""
    tt_ranks = (3, 5)
    ref = jax_decompose(tiny_tensor, tt_ranks, format="tt", method="pallas", iters=ITERS,
                        init="random", seed=0)
    init = [np.asarray(c) for c in jax_init_tt_cores(jax.random.PRNGKey(0), tiny_tensor.shape,
                                                      tt_ranks)]
    out = tt_als(to_port(tiny_tensor), tt_ranks, iters=ITERS, init_cores=init, device="cpu")
    assert out.tt_ranks == tt_ranks
    via_api = decompose(to_port(tiny_tensor), tt_ranks, format="tt", iters=ITERS,
                        init_factors=cores_from_numpy(init, "cpu"), device="cpu")
    assert via_api.fit_history == out.fit_history
    assert_same_model([c.numpy() for c in out.cores], out.fit_history, ref.cores,
                      ref.fit_history, tiny_tensor.indices)


@pytest.mark.parametrize("fixture", sorted(TT_RANKS))
def test_tt_svd_gives_the_reference_cores(request, fixture):
    st = request.getfixturevalue(fixture)
    for got, want in zip(tt_svd(to_port(st), TT_RANKS[fixture], device="cpu"), jax_tt_svd(st, TT_RANKS[fixture])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_validated_tt_ranks_contracts(tiny_tensor):
    """The reference's cases (tests/test_tt.py::test_validated_tt_ranks_contracts)."""
    st = to_port(tiny_tensor)
    assert _validated_tt_ranks(st, 4) == (4, 4)
    assert _validated_tt_ranks(st, (2, 5)) == (2, 5)
    with pytest.raises(ValueError, match="3 entries for a 3-mode tensor"):
        _validated_tt_ranks(st, (2, 2, 2))
    with pytest.raises(ValueError, match="out of range"):
        _validated_tt_ranks(st, (0, 2))
    with pytest.raises(ValueError, match="out of range"):
        _validated_tt_ranks(st, (65, 2))  # bond 0's bound is min(64, 48*80) = 64
    for call in (lambda: tt_als(st, (65, 2), iters=1, device="cpu"),
                 lambda: make_planned_tt(st, (2, 2, 2), device="cpu")):
        with pytest.raises(ValueError, match="tt_ranks|out of range"):
            call()


def test_bad_arguments_raise(tiny_tensor):
    st = to_port(tiny_tensor)
    ws = make_planned_tt(st, (3, 3), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tt_als(st, (4, 4), iters=1, planned=ws, device="cpu")
    with pytest.raises(ValueError, match="ignored"):
        tt_als(st, (3, 3), iters=1, method="reference", planned=ws, device="cpu")
    with pytest.raises(ValueError, match="silently ignored"):
        decompose(st, (3, 3), format="tt", method="reference", iters=1, planned=ws, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        decompose(st, (3, 3), format="tt", method="approach2", iters=1, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        tt_als(st, (3, 3), iters=1, method="pallas_mesh", device="cpu")
    with pytest.raises(ValueError, match="devices=/dist="):
        tt_als(st, (3, 3), iters=1, method="pallas_sharded", device="cpu")
    with pytest.raises(ValueError, match="expected 'auto', 'svd' or 'random'"):
        tt_als(st, (3, 3), iters=1, init="qr", device="cpu")
    cores = init_tt_cores(st.shape, (3, 3), seed=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="pass one of them"):
        tt_als(st, (3, 3), iters=1, init="svd", init_cores=cores, device="cpu")
    with pytest.raises(ValueError, match="initial core 1"):
        tt_als(st, (3, 3), iters=1, init_cores=[cores[0], cores[1][:, :5], cores[2]], device="cpu")
    with pytest.raises(ValueError, match="format='tt' only"):
        decompose(st, 3, format="cp", init="svd", device="cpu")


def test_planned_workspace_reused_with_plans_built_once(tiny_tensor, monkeypatch):
    st = to_port(tiny_tensor)
    built = []
    plan_blocks = ops_module.plan_blocks
    monkeypatch.setattr(ops_module, "plan_blocks", lambda *a, **k: built.append(a[1]) or plan_blocks(*a, **k))
    ws = make_planned_tt(st, (3, 5), device="cpu")
    assert built == [0, 1, 2]
    assert ws.lane_ranks == (3, 15, 5) and ws.rank_pads == (4, 16, 8)
    a = decompose(st, (3, 5), format="tt", iters=2, planned=ws, device="cpu")
    b = decompose(st, (3, 5), format="tt", iters=2, planned=ws, device="cpu")
    assert built == [0, 1, 2]
    c = decompose(st, (3, 5), format="tt", iters=2, device="cpu")
    assert a.fit_history == b.fit_history == c.fit_history
    assert len(built) == 6


def test_sweep_keeps_padding_zero(tensor4d):
    st = to_port(tensor4d)
    tt_ranks = (4, 3, 5)
    ws = make_planned_tt(st, tt_ranks, device="cpu")
    cores = init_tt_cores(st.shape, tt_ranks, seed=0, device=torch.device("cpu"))
    facs = ws.pad_factors([core_to_matrix(c) for c in cores])
    idx, val = tcoo.to_device(st, torch.device("cpu"))
    norm = torch.tensor(tcoo.norm_sq(st), dtype=torch.float32)
    facs, aux, fit = ws.sweep(facs, idx, val, norm)
    assert aux is None and torch.isfinite(fit)
    for f, s, w, rows, rp in zip(facs, st.shape, ws.lane_ranks, ws.padded_rows, ws.rank_pads):
        assert f.shape == (rows, rp)
        assert not f[s:].any() and not f[:, w:].any()


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor5d"])
def test_reference_method_matches_planned(request, fixture):
    """The port's raw-stream method against its planned method on the CPU."""
    st = to_port(request.getfixturevalue(fixture))
    tt_ranks = (3, 5) if st.nmodes == 3 else (2, 4, 3, 2)
    init = init_tt_cores(st.shape, tt_ranks, seed=1, device=torch.device("cpu"))
    a = tt_als(st, tt_ranks, iters=ITERS, init_cores=init, device="cpu")
    b = tt_als(st, tt_ranks, iters=ITERS, init_cores=init, method="reference", device="cpu")
    assert_same_model([c.numpy() for c in a.cores], a.fit_history, [c.numpy() for c in b.cores],
                      b.fit_history, st.indices)


def test_fits_do_not_drop_and_tol_stops_early(tiny_tensor):
    st = to_port(tiny_tensor)
    f = decompose(st, (4, 4), format="tt", iters=5, init="random", device="cpu").fit_history
    assert all(b >= a - FIT_TOL for a, b in zip(f, f[1:]))
    stopped = tt_als(st, (4, 4), iters=50, init="random", tol=1e-2, device="cpu")
    assert len(stopped.fit_history) < 50


def low_tt_rank_tensor(shape=(10, 9, 8), tt_ranks=(2, 3), seed=4) -> tcoo.SparseTensor:
    """Exactly-low-TT-rank tensor with full support in COO form."""
    rng = np.random.default_rng(seed)
    bonds = (1,) + tt_ranks + (1,)
    cores = [torch.tensor(rng.standard_normal((bonds[k], s, bonds[k + 1])))
             for k, s in enumerate(shape)]
    dense = TTState(cores=cores, fit_history=[]).full().numpy()
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    idx = np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)
    return tcoo.SparseTensor(idx, dense.ravel().astype(np.float32), shape)


@pytest.mark.parametrize("method", ["pallas", "reference"])
def test_recovers_low_tt_rank(method):
    """SVD init at the generating bond ranks lands on the tensor; ALS keeps it."""
    st = low_tt_rank_tensor()
    state = tt_als(st, (2, 3), iters=3, method=method, init="svd", device="cpu")
    assert state.fit_history[-1] > 0.999


def test_svd_guard_and_auto_init(small_tensor):
    st = to_port(small_tensor)
    assert np.prod(st.shape) > _TT_SVD_DENSE_LIMIT
    with pytest.raises(ValueError, match="use init='random'"):
        tt_svd(st, (2, 2))
    state = tt_als(st, 2, iters=1, method="reference", init="auto", device="cpu")
    assert len(state.fit_history) == 1


def test_seeded_init_is_left_orthogonal_and_deterministic():
    shape, tt_ranks = (10, 9, 8), (3, 4)
    a = init_tt_cores(shape, tt_ranks, seed=7, device=torch.device("cpu"))
    b = init_tt_cores(shape, tt_ranks, seed=7, device=torch.device("cpu"))
    assert [tuple(c.shape) for c in a] == [(1, 10, 3), (3, 9, 4), (4, 8, 1)]
    for c, d in zip(a, b):
        assert torch.equal(c, d)
    for c in a[:-1]:
        m = c.reshape(c.shape[0] * c.shape[1], c.shape[2])
        torch.testing.assert_close(m.T @ m, torch.eye(m.shape[1]), rtol=0, atol=1e-5)


def test_fit_pieces_against_the_dense_model(tensor4d):
    """tt_inner, tt_norm_sq and tt_fit_value against the dense model and
    tensor (float64), and the core <-> matrix round trip."""
    st = to_port(tensor4d)
    cores = init_tt_cores(st.shape, (2, 3, 2), seed=3, device=torch.device("cpu"))
    for c in cores:
        assert torch.equal(matrix_to_core(core_to_matrix(c), c.shape[0], c.shape[2]), c)
    full = TTState(cores=cores, fit_history=[]).full().double().numpy()
    dense = np.zeros(st.shape)
    np.add.at(dense, tuple(st.indices[:, m] for m in range(4)), st.values.astype(np.float64))
    idx, val = tcoo.to_device(st, torch.device("cpu"))
    inner = float((dense * full).sum())
    assert float(tt_inner(idx, val, cores)) == pytest.approx(inner, rel=1e-5, abs=1e-6)
    assert float(tt_inner(idx, val, cores, elems=100)) == pytest.approx(inner, rel=1e-5, abs=1e-6)
    assert float(tt_norm_sq(cores)) == pytest.approx(float((full ** 2).sum()), rel=1e-5)
    norm = float((dense ** 2).sum())  # no repeated coordinates in this tensor's 4,000
    fit = 1.0 - np.linalg.norm(dense - full) / np.sqrt(norm)
    got = float(tt_fit_value(idx, val, cores, torch.tensor(norm, dtype=torch.float32)))
    assert got == pytest.approx(fit, abs=1e-5)


def test_int_rank_broadcasts(tensor4d):
    st = to_port(tensor4d)
    a = decompose(st, 2, format="tt", iters=2, device="cpu")
    b = decompose(st, (2, 2, 2), format="tt", iters=2, device="cpu")
    assert a.tt_ranks == (2, 2, 2) and a.fit_history == b.fit_history
