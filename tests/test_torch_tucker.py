"""The Tucker slice as a whole: `repro_torch.api.decompose(format="tucker")`
against `repro.api.decompose(format="tucker", method="pallas")` from the
same initial factors on 3/4/5-mode tensors, and the HOOI driver's contracts.

`eigh` fixes no column sign, and the two packages need not pick the same
one, so factors are compared through their projectors U U^T and cores after
aligning each axis's signs, never entry by entry."""
import jax
import numpy as np
import pytest
import torch

from repro.api import decompose as jax_decompose
from repro.tucker import init_tucker_factors as jax_init_tucker_factors
import repro_torch.kernels.ops as ops_module
from repro_torch.api import decompose
from repro_torch.convert import tuckerstate_to_numpy
from repro_torch.core import coo as tcoo
from repro_torch.tucker import (
    core_fit_value,
    init_tucker_factors,
    make_planned_tucker,
    tucker_hooi,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ITERS = 3
FIT_TOL = 1e-5  # the ROADMAP's fit bar; float32 sums in another order
PROJ_TOL = 1e-4  # projectors U U^T, and sign-aligned cores
CORE_RANKS = {
    "tiny_tensor": [(4, 4, 4), (3, 5, 2)],
    "tensor4d": [(3, 3, 3, 3), (3, 4, 2, 3)],
    "tensor5d": [(3, 3, 3, 3, 3), (2, 3, 4, 3, 2)],
}
CASES = [(f, r) for f, rs in CORE_RANKS.items() for r in rs]


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


def reference_init(st, core_ranks):
    """The reference tucker_hooi's own initial factors (hooi.py:357-358)."""
    return [np.asarray(f) for f in jax_init_tucker_factors(jax.random.PRNGKey(0), st.shape, core_ranks)]


def assert_same_decomposition(got: dict, want_factors, want_core, want_fits):
    np.testing.assert_allclose(got["fit_history"], want_fits, rtol=0, atol=FIT_TOL)
    signs = []
    for u, w in zip(got["factors"], want_factors):
        w = np.asarray(w, np.float64)
        u = u.astype(np.float64)
        np.testing.assert_allclose(u @ u.T, w @ w.T, rtol=0, atol=PROJ_TOL)
        signs.append(np.sign(np.diag(w.T @ u)))
    aligned = got["core"].astype(np.float64)
    for axis, s in enumerate(signs):
        shape = [1] * aligned.ndim
        shape[axis] = -1
        aligned = aligned * s.reshape(shape)
    np.testing.assert_allclose(aligned, np.asarray(want_core, np.float64), rtol=0, atol=PROJ_TOL)


@pytest.mark.parametrize("fixture,core_ranks", CASES)
def test_decompose_matches_reference(request, fixture, core_ranks):
    st = request.getfixturevalue(fixture)
    ref = jax_decompose(st, core_ranks, format="tucker", method="pallas", iters=ITERS, seed=0)
    out = tuckerstate_to_numpy(decompose(to_port(st), core_ranks, format="tucker", iters=ITERS,
                                         init_factors=reference_init(st, core_ranks), device="cpu"))
    assert len(out["fit_history"]) == ITERS
    assert out["core"].shape == core_ranks
    assert_same_decomposition(out, ref.factors, ref.core, ref.fit_history)


@pytest.mark.parametrize("fixture,core_ranks", [CASES[1], CASES[3], CASES[5]])
def test_reference_method_matches_jax_reference(request, fixture, core_ranks):
    """method='reference' against the reference's method='reference' from
    its own initial factors: fits to 1e-5 over 3 iterations, projectors and
    sign-aligned cores to 1e-4."""
    st = request.getfixturevalue(fixture)
    ref = jax_decompose(st, core_ranks, format="tucker", method="reference", iters=ITERS, seed=0)
    out = tuckerstate_to_numpy(decompose(to_port(st), core_ranks, format="tucker", method="reference",
                                         iters=ITERS, init_factors=reference_init(st, core_ranks),
                                         device="cpu"))
    assert len(out["fit_history"]) == ITERS
    assert_same_decomposition(out, ref.factors, ref.core, ref.fit_history)


@pytest.mark.parametrize("fixture,core_ranks", [CASES[1], CASES[3], CASES[5]])
def test_reference_method_matches_planned(request, fixture, core_ranks):
    """The port's raw-stream method against its planned method on the CPU."""
    st = to_port(request.getfixturevalue(fixture))
    init = init_tucker_factors(st.shape, core_ranks, seed=1, device=torch.device("cpu"))
    a = tucker_hooi(st, core_ranks, iters=ITERS, init_factors=init, device="cpu")
    b = tucker_hooi(st, core_ranks, iters=ITERS, init_factors=init, method="reference", device="cpu")
    assert_same_decomposition(tuckerstate_to_numpy(a), [f.numpy() for f in b.factors], b.core.numpy(),
                              b.fit_history)


def test_int_rank_broadcasts(tiny_tensor):
    st = to_port(tiny_tensor)
    a = decompose(st, 3, format="tucker", iters=2, seed=4, device="cpu")
    b = decompose(st, (3, 3, 3), format="tucker", iters=2, seed=4, device="cpu")
    assert a.core_ranks == (3, 3, 3) and a.fit_history == b.fit_history


def test_validates_core_ranks(tiny_tensor):
    """The reference's cases (tests/test_tucker.py::test_hooi_validates_core_ranks)."""
    st = to_port(tiny_tensor)
    for ranks, match in [((4, 4), "entries"), ((0, 4, 4), "out of range"),
                         ((4, 4, 1000), "out of range"), ((9, 2, 2), "full row rank")]:
        with pytest.raises(ValueError, match=match):
            tucker_hooi(st, ranks, iters=1, device="cpu")
        with pytest.raises(ValueError, match=match):
            make_planned_tucker(st, ranks, device="cpu")
    ws = make_planned_tucker(st, (4, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="workspace"):
        tucker_hooi(st, (3, 3, 3), iters=1, planned=ws, device="cpu")
    with pytest.raises(ValueError, match="ignored"):
        tucker_hooi(st, (4, 4, 4), iters=1, method="reference", planned=ws, device="cpu")
    with pytest.raises(ValueError, match="silently ignored"):
        decompose(st, (4, 4, 4), format="tucker", method="reference", iters=1, planned=ws,
                  device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        decompose(st, (4, 4, 4), format="tucker", method="approach1", iters=1, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        tucker_hooi(st, (4, 4, 4), iters=1, method="pallas_mesh", device="cpu")
    with pytest.raises(ValueError, match="devices=/dist="):
        tucker_hooi(st, (4, 4, 4), iters=1, method="pallas_sharded", device="cpu")
    with pytest.raises(ValueError, match="initial factor 2"):
        tucker_hooi(st, (4, 4, 4), iters=1, device="cpu",
                    init_factors=[np.zeros((s, 4)) for s in (64, 48, 81)])


def test_planned_workspace_reused_with_plans_built_once(tiny_tensor, monkeypatch):
    st = to_port(tiny_tensor)
    built = []
    plan_blocks = ops_module.plan_blocks
    monkeypatch.setattr(ops_module, "plan_blocks", lambda *a, **k: built.append(a[1]) or plan_blocks(*a, **k))
    ws = make_planned_tucker(st, (3, 5, 2), device="cpu")
    assert built == [0, 1, 2]
    init = reference_init(tiny_tensor, (3, 5, 2))
    a = decompose(st, (3, 5, 2), format="tucker", iters=2, init_factors=init, planned=ws, device="cpu")
    b = decompose(st, (3, 5, 2), format="tucker", iters=2, init_factors=init, planned=ws, device="cpu")
    assert built == [0, 1, 2]
    c = decompose(st, (3, 5, 2), format="tucker", iters=2, init_factors=init, device="cpu")
    assert a.fit_history == b.fit_history == c.fit_history
    assert len(built) == 6


def test_sweep_keeps_padding_zero(tensor4d):
    st = to_port(tensor4d)
    ranks = (3, 4, 2, 3)
    ws = make_planned_tucker(st, ranks, device="cpu")
    facs = ws.pad_factors(init_tucker_factors(st.shape, ranks, seed=0, device=torch.device("cpu")))
    norm = torch.tensor(tcoo.norm_sq(st), dtype=torch.float32)
    facs, core, _ = ws.sweep(facs, norm)
    for f, s, r, rows, rp in zip(facs, st.shape, ranks, ws.padded_rows, ws.rank_pads):
        assert f.shape == (rows, rp)
        assert not f[s:].any() and not f[:, r:].any()
    assert core.shape == ranks


def low_multilinear_rank_tensor(shape=(10, 9, 8), ranks=(2, 3, 2), seed=3) -> tcoo.SparseTensor:
    """Exactly-low-multilinear-rank tensor with full support in COO form."""
    rng = np.random.default_rng(seed)
    core = rng.standard_normal(ranks)
    us = [np.linalg.qr(rng.standard_normal((s, r)))[0] for s, r in zip(shape, ranks)]
    dense = np.einsum("abc,ia,jb,kc->ijk", core, *us)
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    idx = np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)
    return tcoo.SparseTensor(idx, dense.ravel().astype(np.float32), shape)


@pytest.mark.parametrize("method", ["pallas", "reference"])
def test_tol_stops_early(method):
    st = low_multilinear_rank_tensor()
    state = tucker_hooi(st, (2, 3, 2), iters=40, tol=1e-6, method=method, seed=1, device="cpu")
    assert len(state.fit_history) < 40
    assert state.fit_history[-1] > 0.99


def test_factors_orthonormal_and_fit_formula(tiny_tensor):
    """Orthonormal factors, and the core-based fit equals 1 - ||X - X_hat|| /
    ||X|| computed densely on the tiny shape."""
    state = decompose(to_port(tiny_tensor), (4, 4, 4), format="tucker", iters=2, seed=0, device="cpu")
    for f in state.factors:
        np.testing.assert_allclose((f.T @ f).numpy(), np.eye(f.shape[1]), atol=1e-4)
    dense = np.zeros(tiny_tensor.shape, np.float64)
    np.add.at(dense, tuple(tiny_tensor.indices[:, m] for m in range(3)),
              tiny_tensor.values.astype(np.float64))
    us = [f.numpy().astype(np.float64) for f in state.factors]
    recon = np.einsum("abc,ia,jb,kc->ijk", state.core.numpy().astype(np.float64), *us)
    fit_dense = 1.0 - np.linalg.norm(dense - recon) / np.linalg.norm(dense)
    # The reference's bound for this check: the drivers take ||X||^2 as the
    # sum of the squared values, which counts the values of a repeated
    # coordinate apart (the tiny tensor repeats 128 of its 2,000), where the
    # dense tensor adds them first.
    assert abs(fit_dense - state.fit_history[-1]) < 1e-3
    dense_norm = torch.tensor(float((dense ** 2).sum()), dtype=torch.float32)
    assert abs(float(core_fit_value(state.core, dense_norm)) - fit_dense) < 1e-5
    norm = torch.tensor(tcoo.norm_sq(to_port(tiny_tensor)), dtype=torch.float32)
    assert float(core_fit_value(state.core, norm)) == pytest.approx(state.fit_history[-1], abs=1e-6)


def test_seeded_init_is_orthonormal_and_deterministic(tensor5d):
    st = to_port(tensor5d)
    ranks = (2, 3, 4, 3, 2)
    a = init_tucker_factors(st.shape, ranks, seed=7, device=torch.device("cpu"))
    b = init_tucker_factors(st.shape, ranks, seed=7, device=torch.device("cpu"))
    for f, g, s, r in zip(a, b, st.shape, ranks):
        assert f.shape == (s, r) and torch.equal(f, g)
        torch.testing.assert_close(f.T @ f, torch.eye(r), rtol=0, atol=1e-5)
