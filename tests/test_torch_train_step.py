"""The port's LM training path against the JAX package's single-device
(NOPLAN) path on the CPU, for the reduced archs: each starts from the
reference's `init_train_state(PRNGKey(0), ...)` carried over by
`convert.train_state_from_numpy`; `apply_train`'s loss, metrics and
gradients (`jax.grad` against autograd) on the first batch, then 4 steps
of `make_train_step(cfg, opt)` against the port's step on
`TokenPipeline(vocab, 32, 8, seed=0)` batches with attn_chunk 8.  The
harness here also serves `test_torch_train_step_more.py`,
`test_torch_train_step_jamba.py` and `test_torch_train_cases.py`.

Bounds: gradients within TOL_GRAD of each leaf's largest |gradient|; loss
and metrics within TOL_LOSS relative on the first batch; loss, ce,
grad_norm and lr within TOL_STEP relative at every step; parameters after
step 4 within TOL_PARAM of each leaf's largest |value|, except the leaves
named in PARAM_TOL.  Those need more because Adam divides by sqrt(v): a
gradient element near zero, whose sign is float32 rounding in either
package, moves its parameter by about lr either way (the first step moves
every element by lr * sign(g)).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models import transformer as RT
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.train_step import init_train_state as ref_init, make_train_step as ref_make
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.stacks import reference_leaves
from repro_torch.train.train_step import cast_leaves, make_train_step, value_and_grad

B, S, CHUNK, STEPS = 8, 32, 8, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30)
TOL_GRAD, TOL_LOSS, TOL_STEP, TOL_PARAM = 1e-5, 1e-6, 1e-5, 1e-4
STEP_METRICS = ("loss", "ce", "grad_norm", "lr")
# (arch, leaf): bound, each measured at a third or less of it.
PARAM_TOL = {
    # embeddings: rows of rare tokens take gradients near zero (only via
    # their own few positions, or via the softmax of the tied head)
    ("minitron-4b", "embed"): 1e-3,
    ("llama-3.2-vision-11b", "embed"): 1e-3,
    ("llama-3.2-vision-11b", "blocks.1.attn.wv"): 3e-4,
    # a key bias adds q.b to every score of a query, which the softmax
    # ignores: its gradient is zero but for rounding
    ("qwen2-1.5b", "blocks.0.attn.bk"): 2e-2,
    ("qwen2-1.5b", "blocks.0.mlp.wd"): 5e-4,
}


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


def flat(tree) -> dict:
    """{dotted leaf name: float64 array} of a reference-layout tree."""
    out = {}
    for path, leaf in tree_flatten_with_path(tree)[0]:
        name = keystr(path).replace("['", ".").replace("']", "").replace("[", ".").replace("]", "").lstrip(".")
        out[name] = np.asarray(leaf, np.float64)
    return out


def stacked(leaf) -> np.ndarray:
    """A port leaf (a tensor or a stack's layers) as one float64 array."""
    ts = leaf if isinstance(leaf, list) else [leaf]
    arr = np.stack([t.detach().double().numpy() for t in ts])
    return arr if isinstance(leaf, list) else arr[0]


def rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def with_memory(cfg, batch: dict, seed: int, index: int) -> dict:
    """The batch with the memory stream its family reads (whisper frames,
    vision patches; 0.1 x standard normal from (seed, index)), else as is.
    A stub for the tests: the token pipeline carries no memory stream."""
    if cfg.family not in ("audio", "vlm"):
        return batch
    B = batch["tokens"].shape[0]
    rng = np.random.default_rng((seed, index, 1))
    key, rows = ("frames", cfg.encoder_seq) if cfg.family == "audio" else ("images", cfg.img_tokens)
    return dict(batch, **{key: (rng.standard_normal((B, rows, cfg.d_model), np.float32) * 0.1)})


def batches(cfg) -> list[dict]:
    """The steps' batches: the reference's pipeline (the port's equals it,
    tests/test_torch_train.py), plus a stub memory stream for whisper and
    the vision arch (numpy, the same in both)."""
    pipe = RefPipeline(cfg.vocab, S, B, seed=0)
    return [with_memory(cfg, pipe.batch(i), 0, i) for i in range(STEPS)]


@dataclasses.dataclass
class Run:
    arch: str
    cfg: object  # the port's
    init: object  # the reference's initial TrainState as numpy
    batches: list
    loss: float  # apply_train on the first batch
    metrics: dict
    grads: dict  # flat, by the reference's leaf names
    steps: list  # per step {metric: float}
    final: dict  # the final TrainState in the reference's layout, flat params / m / ef
    # The reference's own spread under rounding noise: the largest relative
    # gap over the noise seeds, from the unperturbed run, of {"grads": by
    # leaf, "steps": per step by metric, "params": by leaf after the steps}.
    spread: dict | None = None
    opt: dict = dataclasses.field(default_factory=lambda: dict(OPT))  # AdamWConfig's fields in both packages


def rounded_once(tree, seed: int):
    """`tree` with every float32 element moved by one rounding: times
    1 + u, u uniform in +-2^-24, from numpy's generator `seed`."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        if x.dtype != np.float32:
            return jnp.asarray(x)
        return jnp.asarray(x * (np.float32(1) + rng.uniform(-1, 1, x.shape).astype(np.float32) * np.float32(2.0**-24)))

    return jax.tree.map(move, tree)


def reference_run(arch: str, *, compute_dtype: str | None = None, grads: bool = True, noise_seeds: tuple = (),
                  overrides: dict | None = None, moe: dict | None = None, opt: dict | None = None,
                  **step_kw) -> Run:
    """The reference's gradients on the first batch and its 4 jitted steps;
    with `noise_seeds`, again from the initial parameters moved by one
    rounding (`rounded_once`) for each seed, through the same compiled
    functions, into `Run.spread`.  `overrides`: fields of the reduced
    config set in both packages; `moe`: fields of its MoE config, in both;
    `opt`: AdamWConfig fields beside OPT's, in both."""
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    if compute_dtype:
        rcfg = dataclasses.replace(rcfg, compute_dtype=compute_dtype)
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if overrides:
        rcfg, cfg = dataclasses.replace(rcfg, **overrides), dataclasses.replace(cfg, **overrides)
    if moe:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    opt_kw = dict(OPT, **(opt or {}))
    opt = RefAdamW(**opt_kw)
    state = ref_init(jax.random.PRNGKey(0), rcfg, opt, compress_grads=step_kw.get("compress_grads", False))
    init = jax.tree.map(np.asarray, state)
    bs = batches(cfg)
    loss, metrics, g = None, None, None
    if grads:
        fn = jax.jit(jax.value_and_grad(lambda p, b: RT.apply_train(p, b, rcfg, attn_chunk=CHUNK), has_aux=True))
        (loss, metrics), g = fn(state.params, jax.tree.map(jnp.asarray, bs[0]))
        loss, metrics, g = float(loss), {k: float(v) for k, v in metrics.items()}, flat(g)
    step = jax.jit(ref_make(rcfg, opt, attn_chunk=CHUNK, **step_kw))
    steps = []
    for b in bs:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        steps.append({k: float(m[k]) for k in STEP_METRICS})
    final = {"params": flat(state.params), "m": flat(state.opt["m"])}
    if "ef" in state.opt:
        final["ef"] = flat(state.opt["ef"])
    run = Run(arch, cfg, init, bs, loss, metrics, g, steps, final, opt=opt_kw)
    if noise_seeds:
        run.spread = {"grads": {}, "steps": [{k: 0.0 for k in STEP_METRICS} for _ in bs], "params": {}}
        for seed in noise_seeds:
            state = ref_init(jax.random.PRNGKey(0), rcfg, opt, compress_grads=step_kw.get("compress_grads", False))
            state = type(state)(rounded_once(init.params, seed), state.opt, state.rng)
            if grads:
                _, gn = fn(state.params, jax.tree.map(jnp.asarray, bs[0]))
                _widen(run.spread["grads"], flat(gn), g)
            for i, b in enumerate(bs):
                state, m = step(state, jax.tree.map(jnp.asarray, b))
                for k in STEP_METRICS:
                    gap = abs(float(m[k]) - steps[i][k]) / abs(steps[i][k])
                    run.spread["steps"][i][k] = max(run.spread["steps"][i][k], gap)
            _widen(run.spread["params"], flat(state.params), final["params"])
    return run


def _widen(into: dict, got: dict, want: dict) -> None:
    for name, w in want.items():
        into[name] = max(into.get(name, 0.0), rel(got[name], w))


def port_steps(run: Run, **step_kw) -> tuple[list, dict]:
    """The port's 4 steps from the reference's initial state: per-step
    metrics and the final state in the reference's layout (flat)."""
    state = train_state_from_numpy(run.init, run.cfg, "cpu")
    step = make_train_step(run.cfg, AdamWConfig(**run.opt), attn_chunk=CHUNK, **step_kw)
    steps = []
    for b in run.batches:
        state, m = step(state, b)
        steps.append({k: float(m[k]) for k in STEP_METRICS})
    out = train_state_to_numpy(state, run.cfg)
    assert int(out["opt"]["step"]) == STEPS
    final = {"params": flat(out["params"]), "m": flat(out["opt"]["m"])}
    if "ef" in out["opt"]:
        final["ef"] = flat(out["opt"]["ef"])
    return steps, final


def port_gradients(run: Run) -> tuple[float, dict, dict]:
    """The port's `apply_train` on the first batch from the reference's
    initial parameters: (loss, metrics, {leaf: relative gap of its
    gradient from the reference's})."""
    state = train_state_from_numpy(run.init, run.cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in run.batches[0].items()}
    loss, metrics, grads = value_and_grad(run.cfg, cast_leaves(state.params, run.cfg), batch, attn_chunk=CHUNK)
    mine = reference_leaves(grads, run.cfg.period)
    assert sorted(mine) == sorted(run.grads)
    return float(loss), metrics, {name: rel(stacked(mine[name]), want) for name, want in run.grads.items()}


def check_gradients(run: Run, tol_grad: float = TOL_GRAD, named: dict | None = None, port=None) -> None:
    """`port`: `port_gradients(run)` where it was taken already."""
    loss, metrics, gaps = port or port_gradients(run)
    assert loss == pytest.approx(run.loss, rel=TOL_LOSS)
    assert sorted(metrics) == sorted(run.metrics) == ["ce", "load_balance", "router_z", "tokens"]
    assert int(metrics["tokens"]) == int(run.metrics["tokens"]) == B * S
    for k in ("ce", "load_balance", "router_z"):
        assert float(metrics[k]) == pytest.approx(run.metrics[k], rel=TOL_LOSS, abs=1e-12), k
    for name, gap in gaps.items():
        bound = (named or {}).get(name, tol_grad)
        assert gap <= bound, (name, gap, bound)


def check_steps(run: Run, steps: list, tol: dict | None = None) -> None:
    tol = tol or {}
    for i, (mine, want) in enumerate(zip(steps, run.steps)):
        assert np.isfinite(list(mine.values())).all()
        for k in STEP_METRICS:
            assert mine[k] == pytest.approx(want[k], rel=tol.get(k, TOL_STEP)), (i, k, mine[k], want[k])


def check_params(run: Run, final: dict, tol: float = TOL_PARAM, named: dict | None = None) -> None:
    named = named if named is not None else PARAM_TOL
    assert sorted(final["params"]) == sorted(run.final["params"])
    for name, want in run.final["params"].items():
        bound = named.get((run.arch, name), tol)
        assert rel(final["params"][name], want) <= bound, (name, rel(final["params"][name], want), bound)


ARCHS = ["qwen3-0.6b", "qwen2-1.5b", "phi4-mini-3.8b", "minitron-4b", "mamba2-370m", "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request) -> Run:
    return reference_run(request.param)


def test_apply_train_gradients_match_reference(ref):
    check_gradients(ref)


def test_train_steps_match_reference(ref):
    steps, final = port_steps(ref)
    check_steps(ref, steps)
    check_params(ref, final)
