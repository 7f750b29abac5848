"""The slice as a whole: `repro_torch.api.decompose(format="cp")` against
`repro.api.decompose(format="cp", method="pallas")` from the same initial
factors, on 3/4/5-mode tensors; and the compute-pattern methods
(approach1/approach2 on the remap and copies layouts) and the `mttkrp_fn=`
seam against the reference's `cp_als`."""
import jax
import numpy as np
import pytest
import torch

from repro.api import decompose as jax_decompose
from repro.core.coo import random_factors
from repro.core.cp_als import cp_als as jax_cp_als
from repro_torch.api import decompose
from repro_torch.convert import cpstate_to_numpy
from repro_torch.core import coo as tcoo
from repro_torch.core.cp_als import _normalize, _solve, cp_als
from repro_torch.core.mttkrp import mttkrp_approach2
from repro_torch.kernels.ops import make_planned_cp_als

RANK = 4
ITERS = 3
FIT_TOL = 1e-5  # the ROADMAP's fit bar; float32 sums in another order
FACTOR_TOL = 1e-4


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


def reference_init(st):
    """The reference cp_als's own initial factors (cp_als.py:228-229)."""
    return [np.asarray(f) for f in random_factors(jax.random.PRNGKey(0), st.shape, RANK)]


@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_decompose_matches_reference(request, fixture):
    st = request.getfixturevalue(fixture)
    ref = jax_decompose(st, RANK, format="cp", method="pallas", iters=ITERS, seed=0)
    out = cpstate_to_numpy(decompose(to_port(st), RANK, format="cp", iters=ITERS,
                                     init_factors=reference_init(st), device="cpu"))
    assert len(out["fit_history"]) == ITERS
    np.testing.assert_allclose(out["fit_history"], ref.fit_history, rtol=0, atol=FIT_TOL)
    for got, want in zip(out["factors"], ref.factors):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FACTOR_TOL)
    np.testing.assert_allclose(out["lam"], np.asarray(ref.lam), rtol=FACTOR_TOL, atol=FACTOR_TOL)


@pytest.mark.parametrize("layout", ["remap", "copies"])
@pytest.mark.parametrize("method", ["approach1", "approach2"])
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d", "tensor5d"])
def test_compute_patterns_match_reference(request, fixture, method, layout):
    """The reference's cp_als with the same method and layout, from its own
    initial factors (random_factors(PRNGKey(0))): fits to 1e-5 over 3
    iterations, factors to 1e-4."""
    st = request.getfixturevalue(fixture)
    ref = jax_cp_als(st, RANK, iters=ITERS, method=method, layout=layout, seed=0)
    out = cpstate_to_numpy(decompose(to_port(st), RANK, method=method, layout=layout, iters=ITERS,
                                     init_factors=reference_init(st), device="cpu"))
    assert len(out["fit_history"]) == ITERS
    np.testing.assert_allclose(out["fit_history"], ref.fit_history, rtol=0, atol=FIT_TOL)
    for got, want in zip(out["factors"], ref.factors):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FACTOR_TOL)


def test_mttkrp_fn_seam(tiny_tensor):
    """`mttkrp_fn=` runs the per-mode loop with the caller's MTTKRP: the
    planned kernel through `PlannedCPALS.mttkrp_fn` gives the planned path's
    fits and the reference's pallas fits; the approach-2 function gives the
    approach-2 method's run exactly."""
    st = to_port(tiny_tensor)
    init = reference_init(tiny_tensor)
    ws = make_planned_cp_als(st, RANK, device="cpu")
    seam = cp_als(st, RANK, iters=ITERS, init_factors=init, mttkrp_fn=ws.mttkrp_fn, device="cpu")
    planned = cp_als(st, RANK, iters=ITERS, init_factors=init, planned=ws, device="cpu")
    ref = jax_decompose(tiny_tensor, RANK, format="cp", method="pallas", iters=ITERS, seed=0)
    np.testing.assert_allclose(seam.fit_history, planned.fit_history, rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(seam.fit_history, ref.fit_history, rtol=0, atol=FIT_TOL)
    calls = []

    def counted(*args):
        calls.append(args[3])
        return mttkrp_approach2(*args)

    for layout in ("remap", "copies"):
        calls.clear()
        a = cp_als(st, RANK, iters=2, method="approach2", layout=layout, init_factors=init,
                   mttkrp_fn=counted, device="cpu")
        b = cp_als(st, RANK, iters=2, method="approach2", layout=layout, init_factors=init,
                   device="cpu")
        assert a.fit_history == b.fit_history and calls == [0, 1, 2] * 2


def test_planned_workspace_reuse_and_padding(tiny_tensor):
    """A prebuilt workspace gives the same run; padding stays exactly zero."""
    st = to_port(tiny_tensor)
    init = reference_init(tiny_tensor)
    ws = make_planned_cp_als(st, RANK, device="cpu")
    a = decompose(st, RANK, iters=2, init_factors=init, planned=ws, device="cpu")
    b = decompose(st, RANK, iters=2, init_factors=init, device="cpu")
    assert a.fit_history == b.fit_history
    facs = ws.pad_factors([torch.tensor(f) for f in init])
    idx, val = tcoo.to_device(st, torch.device("cpu"))
    norm = torch.tensor(tcoo.norm_sq(st), dtype=torch.float32)
    facs, _, _ = ws.sweep(facs, idx, val, norm, first=True)
    for f, s, rows in zip(facs, st.shape, ws.padded_rows):
        assert f.shape == (rows, ws.rank_pad)
        assert not f[s:].any() and not f[:, RANK:].any()
    with pytest.raises(ValueError, match="does not match"):
        decompose(st, RANK + 1, iters=1, planned=ws, device="cpu")


def test_seeded_init_is_deterministic_and_tol_stops_early(tiny_tensor):
    st = to_port(tiny_tensor)
    a = decompose(st, RANK, iters=4, seed=5, device="cpu")
    b = decompose(st, RANK, iters=4, seed=5, device="cpu")
    assert a.fit_history == b.fit_history and len(a.fit_history) == 4
    c = decompose(st, RANK, iters=50, seed=5, tol=1.0, device="cpu")
    assert len(c.fit_history) == 2


def test_tt_runs_on_cpu(tiny_tensor):
    state = decompose(to_port(tiny_tensor), RANK, format="tt", iters=2, device="cpu")
    assert state.tt_ranks == (RANK,) * 2 and len(state.fit_history) == 2


def test_tucker_runs_on_cpu(tiny_tensor):
    state = decompose(to_port(tiny_tensor), RANK, format="tucker", iters=2, device="cpu")
    assert state.core_ranks == (RANK,) * 3 and len(state.fit_history) == 2


def test_bad_arguments_raise(tiny_tensor):
    st = to_port(tiny_tensor)
    with pytest.raises(ValueError, match="unknown format"):
        decompose(st, RANK, format="parafac", device="cpu")
    with pytest.raises(ValueError, match="single integer rank"):
        decompose(st, (4, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="initial factor 1"):
        decompose(st, RANK, init_factors=[np.zeros((s, RANK)) for s in (64, 47, 80)], device="cpu")
    ws = make_planned_cp_als(st, RANK, device="cpu")
    for kw, match in ((dict(method="reference"), "unknown method"),
                      (dict(method="approach3"), "unknown method"),
                      (dict(method="approach1", layout="tiles"), "unknown layout"),
                      (dict(method="approach1", planned=ws), "would be silently ignored"),
                      (dict(method="approach2", planned=ws), "would be silently ignored")):
        with pytest.raises(ValueError, match=match):
            decompose(st, RANK, iters=1, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown method"):
        cp_als(st, RANK, iters=1, method="pallas_sharded", device="cpu")
    with pytest.raises(ValueError, match="silently ignored"):
        cp_als(st, RANK, iters=1, planned=ws, mttkrp_fn=ws.mttkrp_fn, device="cpu")
    with pytest.raises(ValueError, match="format='cp' only"):
        decompose(st, 2, format="tucker", layout="copies", device="cpu")


def test_normalize_first_iteration_rule():
    """First iteration divides by max(norm, 1); later ones by the norm,
    guarded against 0 (the reference's convention)."""
    f = torch.tensor([[0.3, 3.0, 0.0], [0.4, 4.0, 0.0]])
    g, n = _normalize(f, 0)
    torch.testing.assert_close(n, torch.tensor([1.0, 5.0, 1.0]))
    torch.testing.assert_close(g[:, 0], f[:, 0])
    g, n = _normalize(f, 1)
    torch.testing.assert_close(n, torch.tensor([0.5, 5.0, 1.0]))
    torch.testing.assert_close(g[:, 0], torch.tensor([0.6, 0.8]))


def test_cholesky_solve_matches_dense_solve():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((30, 5)).astype(np.float32)
    g = torch.tensor(a.T @ a)
    m = torch.tensor(rng.standard_normal((12, 5)).astype(np.float32))
    want = np.linalg.solve(a.T.astype(np.float64) @ a + 1e-8 * np.eye(5), m.numpy().T.astype(np.float64)).T
    np.testing.assert_allclose(_solve(m, g).numpy(), want, rtol=1e-4, atol=1e-5)
