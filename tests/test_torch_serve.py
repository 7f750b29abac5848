"""The port's serving slice against the JAX package on the CPU, for each of
the ten architectures at `reduced()`: the reference's `init_params` carried
across by `convert.params_from_numpy`, then prefill (last logits and every
cache leaf), four decode steps fed the reference's greedy tokens, and
`generate`; the reference's own serving properties held by the port; one
bfloat16 case; `launch.serve.main`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.serve import engine as RE
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import caches_from_numpy, caches_to_numpy, params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve.engine import cache_specs, generate, make_decode_step, make_prefill_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = list_configs()
B, S, STEPS, CHUNK = 2, 16, 4, 8
# float32 on both sides, sums in other orders: every logit and cache leaf
# within TOL of the largest |value| of the reference's tensor.
TOL = 1e-4
# bfloat16 compute on both sides: the rounding of a bfloat16 activation
# (2^-8 relative) in other orders through two layers.
TOL_BF16 = 3e-2
CPU = torch.device("cpu")


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def batch_np(cfg) -> dict:
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.family == "audio":
        batch["frames"] = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        batch["images"] = (rng.standard_normal((B, cfg.img_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def to_torch(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


@dataclasses.dataclass
class RefRun:
    arch: str
    cfg: object
    tree: dict
    batch: dict
    prefill_logits: np.ndarray
    prefill_caches: tuple
    step_tokens: list  # the greedy token fed to each decode step, (B, 1)
    step_logits: list
    generated: np.ndarray | None


def reference_run(arch: str, cfg=None, *, with_generate: bool = True) -> RefRun:
    """The reference's prefill (eager, as tests/test_models.py runs it),
    STEPS jitted decode steps and `generate`, on its own parameters."""
    cfg = cfg or ref_get_config(arch).reduced()
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    batch = batch_np(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, caches = RT.prefill(params, jb, cfg, cache_len=S + STEPS + 1, attn_chunk=CHUNK)
    pre_logits, pre_caches = np.asarray(logits), jax.tree.map(np.asarray, caches)
    cur = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    pos = jnp.full((B,), S, jnp.int32)
    decode = jax.jit(RE.make_decode_step(cfg))
    toks, step_logits = [], []
    for _ in range(STEPS):
        toks.append(np.asarray(cur))
        cur, logits, caches = decode(params, cur, pos, caches, jb)
        step_logits.append(np.asarray(logits))
        pos = pos + 1
    generated = (np.asarray(RE.generate(params, jb, cfg, max_new_tokens=STEPS, attn_chunk=CHUNK))
                 if with_generate else None)
    return RefRun(arch, cfg, jax.tree.map(np.asarray, params), batch, pre_logits, pre_caches, toks,
                  step_logits, generated)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request) -> RefRun:
    return reference_run(request.param)


def test_prefill_matches_reference(ref):
    cfg = get_config(ref.arch).reduced()
    params = params_from_numpy(ref.tree, cfg, CPU)
    logits, caches = T.prefill(params, to_torch(ref.batch), cfg, cache_len=S + STEPS + 1, attn_chunk=CHUNK)
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.vocab)
    assert rel_err(logits, ref.prefill_logits) <= TOL
    got = caches_to_numpy(caches, cfg)
    assert len(got) == len(ref.prefill_caches) == cfg.period
    for mine, theirs in zip(got, ref.prefill_caches):
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            assert mine[k].dtype == theirs[k].dtype, k
            assert rel_err(mine[k], theirs[k]) <= TOL, k


def test_decode_steps_match_reference(ref):
    cfg = get_config(ref.arch).reduced()
    params = params_from_numpy(ref.tree, cfg, CPU)
    batch = to_torch(ref.batch)
    # from the reference's own caches, so each step is held alone
    caches = caches_from_numpy(ref.prefill_caches, cfg, CPU)
    pos = torch.full((B,), S, dtype=torch.int64)
    for tok, want in zip(ref.step_tokens, ref.step_logits):
        logits, caches = T.decode_step(params, torch.tensor(tok), pos, caches, batch, cfg)
        assert rel_err(logits, want) <= TOL
        pos = pos + 1


def test_generate_matches_reference(ref):
    cfg = get_config(ref.arch).reduced()
    params = params_from_numpy(ref.tree, cfg, CPU)
    out = generate(params, to_torch(ref.batch), cfg, max_new_tokens=STEPS, attn_chunk=CHUNK, device="cpu")
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref.generated)


def test_decode_after_prefill_equals_longer_prefill(ref):
    """tests/test_models.py:72 for the port: a decode step after a prefill
    over S tokens gives the logits of a prefill over the S + 1 tokens."""
    cfg = get_config(ref.arch).reduced()
    params = params_from_numpy(ref.tree, cfg, CPU)
    batch = to_torch(ref.batch)
    logits, caches = T.prefill(params, batch, cfg, cache_len=S + 4, attn_chunk=CHUNK)
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    dec, _ = T.decode_step(params, nxt, torch.full((B,), S), caches, batch, cfg)
    longer = dict(batch, tokens=torch.cat([batch["tokens"], nxt], 1))
    want, _ = T.prefill(params, longer, cfg, attn_chunk=1)
    assert rel_err(dec, want) <= TOL


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m", "jamba-v0.1-52b"])
def test_generate_matches_stepwise_prefill(arch):
    """tests/test_serve.py:12 for the port: greedy generate() == argmax of
    a full pass over the prompt and the tokens so far, token by token."""
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (1, 12), dtype=np.int32))}
    out = generate(params, batch, cfg, max_new_tokens=4, attn_chunk=4, device="cpu")
    assert out.shape == (1, 4)
    toks, want = batch["tokens"], []
    for _ in range(4):
        logits, _ = T.prefill(params, {"tokens": toks}, cfg, attn_chunk=1)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        want.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], 1)
    np.testing.assert_array_equal(out[0].numpy(), torch.stack(want, 1)[0].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_real_caches(arch):
    """tests/test_serve.py:33 for the port (every arch): the meta-device
    specs have the real caches' shapes and dtypes, and the reference's."""
    cfg = get_config(arch).reduced()
    specs = cache_specs(cfg, batch=2, cache_len=32)
    real = T.init_caches(cfg, batch=2, cache_len=32, device="cpu")
    ref = jax.tree.map(np.asarray, RT.init_caches(ref_get_config(arch).reduced(), 2, 32))
    assert all(t.device.type == "meta" for c in specs for t in c.values())
    assert [{k: (tuple(t.shape), t.dtype) for k, t in c.items()} for c in specs] == \
        [{k: (tuple(t.shape), t.dtype) for k, t in c.items()} for c in real]
    mine = caches_to_numpy(real, cfg)
    for a, b in zip(mine, ref):
        assert {k: (v.shape, v.dtype) for k, v in a.items()} == {k: (v.shape, v.dtype) for k, v in b.items()}


def test_step_builders():
    """tests/test_serve.py:45 for the port: the builders' steps."""
    cfg = get_config("qwen3-0.6b").reduced()
    params = T.init_params(cfg, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, 8), generator=torch.Generator().manual_seed(0))}
    logits, caches = make_prefill_step(cfg, cache_len=10, attn_chunk=4)(params, batch)
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    tok2, logits2, caches = make_decode_step(cfg)(params, nxt, torch.full((B,), 8), caches, batch)
    assert tok2.shape == (B, 1) and tok2.dtype == torch.int32 and logits2.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(logits2).all())
    with pytest.raises(ValueError, match="greedy"):
        make_decode_step(cfg, sample="top_p")


def test_caches_round_trip():
    cfg = get_config("jamba-v0.1-52b").reduced()
    tree = jax.tree.map(np.asarray, RT.init_caches(ref_get_config("jamba-v0.1-52b").reduced(), 2, 8))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(a.dtype), tree)
    back = caches_to_numpy(caches_from_numpy(tree, cfg, CPU), cfg)
    for a, b in zip(back, tree):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_params_from_numpy_refuses_another_tree():
    cfg = get_config("qwen3-0.6b").reduced()
    tree = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(0), ref_get_config("qwen3-0.6b").reduced()))
    del tree["norm_f"]
    with pytest.raises(ValueError, match="leaves differ"):
        params_from_numpy(tree, cfg, CPU)
    other = get_config("qwen2-1.5b").reduced()  # qkv bias, no qk norm
    tree = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(0), ref_get_config("qwen2-1.5b").reduced()))
    with pytest.raises(ValueError):
        params_from_numpy(tree, dataclasses.replace(other, d_ff=96), CPU)


def test_bfloat16_against_reference():
    """qwen3-0.6b reduced with bfloat16 compute (float32 parameters) on both
    sides: prefill and decode logits within TOL_BF16, bfloat16 KV caches."""
    arch = "qwen3-0.6b"
    ref = reference_run(arch, dataclasses.replace(ref_get_config(arch).reduced(), compute_dtype="bfloat16"),
                        with_generate=False)
    cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="bfloat16")
    params = params_from_numpy(ref.tree, cfg, CPU)
    batch = to_torch(ref.batch)
    logits, caches = T.prefill(params, batch, cfg, cache_len=S + STEPS + 1, attn_chunk=CHUNK)
    assert logits.dtype == torch.float32 and caches[0]["k"].dtype == torch.bfloat16
    assert rel_err(logits, ref.prefill_logits) <= TOL_BF16
    caches = caches_from_numpy(ref.prefill_caches, cfg, CPU)
    assert caches[0]["k"].dtype == torch.bfloat16
    pos = torch.full((B,), S, dtype=torch.int64)
    for tok, want in zip(ref.step_tokens, ref.step_logits):
        logits, caches = T.decode_step(params, torch.tensor(tok), pos, caches, batch, cfg)
        assert rel_err(logits, want) <= TOL_BF16
        pos = pos + 1


def test_launch_serve_prints_four_lines(capsys):
    assert launch_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch", "2",
                              "--prompt-len", "8", "--new-tokens", "4", "--attn-chunk", "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all(ln.startswith("[serve] ") for ln in lines)
    assert lines[0] == "[serve] arch=qwen3-0.6b batch=2 prompt=8 new=4"
    assert "tok/s" in lines[1] and "ms)" in lines[1] and "ms/step" in lines[2]
    assert "sample continuation ids: [" in lines[3]


@pytest.mark.parametrize("mesh", [["--mesh-data", "2"], ["--mesh-model", "2"]])
def test_launch_serve_refuses_a_mesh(mesh):
    """Without a process group (no torchrun) a mesh of more than one
    device is refused: the launcher cannot start its ranks itself."""
    with pytest.raises(ValueError, match="needs as many ranks"):
        launch_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", *mesh])


def test_serve_run_is_seeded():
    cfg = get_config("mamba2-370m").reduced()
    a = launch_serve.serve(cfg, batch=2, prompt_len=8, new_tokens=3, seed=5, device="cpu")
    b = launch_serve.serve(cfg, batch=2, prompt_len=8, new_tokens=3, seed=5, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and a["tokens"].shape == (2, 3)
