"""The port's training substrate against the JAX package on the CPU: the
token pipeline bit for bit, int8 quantization and error feedback, the LR
schedule, AdamW on a random tree (float32 and bfloat16 state, factored
second moment, clipping), `update_slices` against the unsliced update, and
the masked cross-entropy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.dist import compression as RC
from repro.models import transformer as RT
from repro.train import optimizer as RO
from repro_torch.data.pipeline import TokenPipeline, make_batch_iterator
from repro_torch.dist import compression as C
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's tests, whatever the machine: the
    suite runs several workers on its cores, and torch's default of a
    thread per core in each turns eager CPU work into contention; and a
    fixed count fixes the float32 summation orders that the measured
    bounds below were taken with (one thread sums in others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def np_of(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# token pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [(256, 32, 8, 0), (151_936, 16, 4, 3), (51_866, 8, 6, 1)])
def test_pipeline_batches_equal_reference(vocab, seq, batch, seed):
    mine, ref = TokenPipeline(vocab, seq, batch, seed=seed), RefPipeline(vocab, seq, batch, seed=seed)
    for index in (0, 1, 7, 123):
        a, b = mine.batch(index), ref.batch(index)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    for sl in (slice(0, batch // 2), slice(batch // 2, batch)):
        a, b = mine.batch(5, host_slice=sl), ref.batch(5, host_slice=sl)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_batch_iterator_is_seekable():
    pipe = TokenPipeline(256, 16, 4, seed=0)
    it = make_batch_iterator(pipe, start_index=3, depth=2)
    got = [next(it) for _ in range(3)]
    it.close()
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"], pipe.batch(3 + i)["tokens"])


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((64, 64), 3.0), ((7, 5, 3), 1e-3), ((1000,), 40.0)])
def test_quantize_int8_equals_reference(shape, scale):
    x = (np.random.default_rng(0).standard_normal(shape) * scale).astype(np.float32)
    q, s = C.quantize_int8(torch.tensor(x))
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    # the scale is one float32 division, as the reference's: equal
    assert float(s) == float(rs)
    np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(), np.asarray(RC.dequantize_int8(rq, rs)))


def test_quantize_zero_tensor_floors_scale():
    q, s = C.quantize_int8(torch.zeros(5))
    assert float(s) == pytest.approx(1e-30) and int(q.abs().max()) == 0


def test_compress_decompress_matches_reference_over_steps():
    """Five steps of error feedback on a tree with a stack (one scale over
    its layers, as the reference's stacked leaf): dequantized gradients and
    residuals equal the reference's bit for bit (the same float32 ops in the
    same order), and the residual stays within scale/2."""
    rng = np.random.default_rng(1)
    state, ref_state = {}, {}
    for step in range(5):
        a = (rng.standard_normal((6, 5)) * 0.1).astype(np.float32)
        s = (rng.standard_normal((3, 4, 2)) * [[[1.0]], [[3.0]], [[0.01]]]).astype(np.float32)
        deq, state = C.compress_decompress({"a": torch.tensor(a), "s": [torch.tensor(x) for x in s]}, state)
        rdeq, ref_state = RC.compress_decompress({"a": jnp.asarray(a), "s": jnp.asarray(s)}, ref_state)
        np.testing.assert_array_equal(deq["a"].numpy(), np.asarray(rdeq["a"]))
        np.testing.assert_array_equal(np.stack([x.numpy() for x in deq["s"]]), np.asarray(rdeq["s"]))
        np.testing.assert_array_equal(state["ef"]["a"].numpy(), np.asarray(ref_state["ef"]["a"]))
        ef_s = np.stack([x.numpy() for x in state["ef"]["s"]])
        np.testing.assert_array_equal(ef_s, np.asarray(ref_state["ef"]["s"]))
        assert np.abs(ef_s).max() <= np.abs(np.stack([d.numpy() for d in deq["s"]]) + ef_s).max() / 127 / 2 * 1.001


def test_compress_keeps_gradient_dtype_and_seeded_residual():
    g = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    opt = C.init_error_feedback({"m": 1}, {"w": torch.zeros(4, 4)})
    assert opt["m"] == 1 and opt["ef"]["w"].dtype == torch.float32
    deq, opt = C.compress_decompress(g, opt)
    assert deq["w"].dtype == torch.bfloat16 and opt["m"] == 1


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_lr_schedule_equals_reference():
    for cfg_kw in ({}, {"warmup_steps": 10, "total_steps": 100, "min_lr_frac": 0.1, "lr": 1e-3},
                   {"warmup_steps": 0, "total_steps": 30}):
        mine, ref = O.AdamWConfig(**cfg_kw), RO.AdamWConfig(**cfg_kw)
        steps = np.arange(0, mine.total_steps + 2, max(1, mine.total_steps // 50), dtype=np.int32)
        got = np.array([float(O.lr_at(mine, torch.tensor(s))) for s in steps])
        want = np.array([float(RO.lr_at(ref, jnp.asarray(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_config_fields_equal_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(O.AdamWConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(RO.AdamWConfig)]


def random_tree(seed: int) -> dict:
    """Numpy leaves: a matrix, a vector, a 3-D leaf, a scalar; two stacks
    (the port's lists, the reference's leading axis): of matrices and of
    vectors (whose factored moment couples the layers)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"a": f(8, 6), "b": f(5), "c": f(3, 4, 5), "d": f(), "s": f(3, 6, 4), "n": f(4, 7)}


def to_port(tree: dict) -> dict:
    return {k: ([torch.tensor(x) for x in v] if k in ("s", "n") else torch.tensor(v)) for k, v in tree.items()}


def from_port(tree: dict) -> dict:
    return {k: np.stack([np_of(x) for x in v]) if isinstance(v, list) else np_of(v) for k, v in tree.items()}


@pytest.mark.parametrize("state_dtype,factored", [("float32", False), ("bfloat16", False), ("float32", True),
                                                  ("bfloat16", True)])
def test_adamw_update_matches_reference(state_dtype, factored):
    """Five steps with clipping active (gradient norms about 20, clip 1):
    parameters and m within 1e-6 of each leaf's largest |value| (one float32
    rounding of lr * update; bfloat16 m/v are rounded as the reference
    rounds them: within 1e-5), grad_norm and lr within 1e-6 relative."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, state_dtype=state_dtype, factored_v=factored)
    cfg, rcfg = O.AdamWConfig(**kw), RO.AdamWConfig(**kw)
    params, ref = to_port(random_tree(0)), {k: jnp.asarray(v) for k, v in random_tree(0).items()}
    state, ref_state = O.adamw_init(params, cfg), RO.adamw_init(ref, rcfg)
    tol = 1e-6 if state_dtype == "float32" else 1e-5
    for step in range(5):
        g = {k: v * 4 for k, v in random_tree(10 + step).items()}
        params, state, m = O.adamw_update(params, to_port(g), state, cfg)
        ref, ref_state, rm = RO.adamw_update(ref, {k: jnp.asarray(v) for k, v in g.items()}, ref_state, rcfg)
        assert float(m["grad_norm"]) > 10 * cfg.clip_norm
        for k in ("grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-6)
        for k, want in ref.items():
            want = np.asarray(want)
            got = from_port({k: params[k]})[k]
            assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), k
            got_m, want_m = from_port({k: state["m"][k]})[k], np.asarray(ref_state["m"][k], np.float32)
            assert np.abs(got_m - want_m).max() <= tol * max(np.abs(want_m).max(), 1e-30), k
        assert int(state["step"]) == int(ref_state["step"]) == step + 1
    if factored:  # r/c on rank >= 2: per layer for the stack of matrices, one pair for the vectors
        assert set(state["v"]["a"]) == {"r", "c"} and isinstance(state["v"]["s"], list)
        assert tuple(state["v"]["n"]["r"].shape) == (4,) and tuple(state["v"]["n"]["c"].shape) == (7,)
        np.testing.assert_allclose(state["v"]["n"]["c"].numpy(), np.asarray(ref_state["v"]["n"]["c"]), rtol=1e-5)
        assert not isinstance(state["v"]["b"], dict)


def test_adamw_keeps_unknown_state_keys():
    params = {"w": torch.ones(3, 3)}
    state = dict(O.adamw_init(params, O.AdamWConfig()), ef={"w": torch.zeros(3, 3)})
    _, new, _ = O.adamw_update(params, {"w": torch.ones(3, 3)}, state, O.AdamWConfig())
    assert "ef" in new and new["ef"] is state["ef"]


@pytest.mark.parametrize("factored", [False, True])
def test_update_slices_bit_identical(monkeypatch, factored):
    """The sliced update of a tensor of 3 dimensions equals the unsliced
    one bit for bit (the threshold lowered so a small leaf qualifies)."""
    monkeypatch.setattr(O, "SLICE_MIN_ELEMENTS", 64)
    outs = []
    for slices in (1, 4):
        cfg = O.AdamWConfig(lr=1e-2, warmup_steps=0, update_slices=slices, factored_v=factored)
        gen = torch.Generator().manual_seed(0)
        params = {"e": torch.randn((8, 6, 5), generator=gen), "s": [torch.randn((4, 6, 5), generator=gen)
                                                                  for _ in range(2)]}
        state = O.adamw_init(params, cfg)
        for _ in range(3):
            g = {"e": torch.randn((8, 6, 5), generator=gen), "s": [torch.randn((4, 6, 5), generator=gen)
                                                                 for _ in range(2)]}
            params, state, _ = O.adamw_update(params, g, state, cfg)
        outs.append((params, state))
    (p1, s1), (p4, s4) = outs
    assert torch.equal(p1["e"], p4["e"]) and all(torch.equal(a, b) for a, b in zip(p1["s"], p4["s"]))
    assert torch.equal(s1["m"]["e"], s4["m"]["e"])
    v1, v4 = s1["v"]["e"], s4["v"]["e"]
    assert all(torch.equal(v1[k], v4[k]) for k in v1) if factored else torch.equal(v1, v4)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------


def test_cross_entropy_ignores_negative_labels():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 6] = -100
    s, n = T.cross_entropy(torch.tensor(logits), torch.tensor(labels))
    rs, rn = RT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert int(n) == int(rn) == 21 - 5
    assert float(s) == pytest.approx(float(rs), rel=1e-6)
    # an ignored label moves nothing
    lt = torch.tensor(logits, requires_grad=True)
    T.cross_entropy(lt, torch.tensor(labels))[0].backward()
    assert float(lt.grad[0, :4].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the SSD scan's gradient where its decays are large
# ---------------------------------------------------------------------------


def test_ssd_gradient_finite_where_the_reference_overflows():
    """Decays whose sum over a chunk passes 88 (mamba2-370m's at full width,
    chunk 256): exp(l_t - l_s) above the diagonal overflows to inf.  The
    port exponentiates only the kept deltas: the same outputs, finite
    gradients; the reference's gradient is NaN there (inf times a zero
    cotangent)."""
    from repro.models import ssm as RS
    from repro_torch.models import ssm as S

    rng = np.random.default_rng(0)
    Bsz, L, H, P, G, N = 1, 32, 4, 8, 1, 8
    x = rng.standard_normal((Bsz, L, H, P)).astype(np.float32)
    dt = np.full((Bsz, L, H), 2.0, np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)  # |dt A| summed over 32 steps: up to 256
    Bm = rng.standard_normal((Bsz, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, L, G, N)).astype(np.float32)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, dt, A, Bm, Cm)]
    y, h = S.ssd_chunked(*ts, chunk=L)
    (y.sum() + h.sum()).backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in ts)
    ry, rh = RS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=L)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(rh), rtol=1e-5, atol=1e-5)
    rg = jax.grad(lambda d: RS.ssd_chunked(jnp.asarray(x), d, jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(Cm),
                                           chunk=L)[0].sum())(jnp.asarray(dt))
    assert bool(jnp.isnan(rg).any())


# ---------------------------------------------------------------------------
# train states: the converters and checkpoints
# ---------------------------------------------------------------------------


def test_train_state_round_trips(tmp_path):
    """The reference's train state (stacks of matrices and of vectors,
    factored r/c, bfloat16 moments, the int8 residual) into the port and
    back equals itself; a checkpoint of the port's state restores into a
    fresh one bit for bit."""
    from jax.tree_util import keystr, tree_flatten_with_path

    from repro.configs import get_config as ref_get_config
    from repro.train.train_step import init_train_state as ref_init
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
    from repro_torch.train.checkpoint import CheckpointManager, restore_train_state, save_train_state
    from repro_torch.train.train_step import init_train_state

    kw = dict(factored_v=True, state_dtype="bfloat16")
    cfg = get_config("qwen3-0.6b").reduced()
    ref = ref_init(jax.random.PRNGKey(1), ref_get_config("qwen3-0.6b").reduced(), RO.AdamWConfig(**kw),
                   compress_grads=True)
    ref = jax.tree.map(np.asarray, ref)  # bfloat16 moments stay bfloat16 (ml_dtypes)
    state = train_state_from_numpy(ref, cfg, "cpu")
    assert state.opt["m"]["embed"].dtype == torch.bfloat16 and state.opt["step"].dtype == torch.int32
    back = train_state_to_numpy(state, cfg)

    def flat(tree):  # bfloat16 as float32, exactly
        return {keystr(p): np.asarray(v, np.float32) if np.asarray(v).dtype.name == "bfloat16" else np.asarray(v)
                for p, v in tree_flatten_with_path(tree)[0]}

    for part in ("params", "opt"):
        want, got = flat(getattr(ref, part)), flat(back[part])
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    mgr = CheckpointManager(str(tmp_path))
    save_train_state(mgr, 7, state, blocking=False)
    mgr.wait()
    fresh = init_train_state(cfg, O.AdamWConfig(**kw), device="cpu", compress_grads=True)
    assert restore_train_state(mgr, fresh) == 7
    again = train_state_to_numpy(fresh, cfg)
    for part in ("params", "opt"):
        want, got = flat(back[part]), flat(again[part])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    other = init_train_state(cfg, O.AdamWConfig(), device="cpu")  # no residual, unfactored
    with pytest.raises(ValueError, match="checkpoint"):
        restore_train_state(mgr, other)
