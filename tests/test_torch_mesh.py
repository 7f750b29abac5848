"""The port's LM stack on a `DeviceMesh`: 4 gloo ranks on the CPU
(tests/torch_mesh_worker.py, spawned once for the module) run a 2 x 2 and a
1 x 4 ("data", "model") mesh, while this process runs the JAX package's
single-device (NOPLAN) path on the same inputs.

  * Train: 3 steps from the reference's initial state (`init_train_state(
    PRNGKey(0), ...)`, jitted, carried over by
    `convert.train_state_from_numpy`) on
    the batches of tests/test_torch_train_step.py, held to the reference's
    NOPLAN step at that file's bounds for the arch (jamba's from
    tests/test_torch_train_step_jamba.py): qwen3-0.6b with fsdp on and 2
    float32 microbatches (`accum_dtype` given) of 8 rows each, qwen3-0.6b
    with int8 error feedback (held at tests/test_torch_train_cases.py's
    int8 bounds, its residuals too), phi3.5-moe, jamba (one period),
    whisper with remat on (fed by `with_memory`); on the 1 x 4 mesh a
    qwen3 variant whose 6 heads and 3 KV heads the model axis does not
    divide (scores on the query chunk, K/V on the sequence).  Every
    parameter, gradient and moment is a DTensor at its spec's placements.
    The two 2 x 2 qwen3 cases start from one initial state (fsdp leaves it
    as it is).
  * Save: `save_train_state` of the fsdp case's final state gathers its
    leaves one at a time, never two whole leaves alive at once.
  * Serve: prefill + 4 greedy decode steps (`generate`), tokens equal to
    the reference's, for jamba on 2 x 2 (its KV cache head-sharded, its
    Mamba states at their specs) and the variant on 1 x 4 (its KV cache
    sequence-sharded, so each decode write lands on one rank).
  * The embedding's fallback layout: vocabularies are padded to 256 rows,
    which every power-of-two model axis divides, so no config reaches it
    here; the worker places a table at the fallback spec P(None, "model")
    and holds the sharded embedding's forward and gradient to the plain
    gather's.
  * Launcher: `launch.train.main` on the 1 x 4 mesh (with int8 error
    feedback, so the residual is saved too) saves at step 2; on the 2 x 2
    mesh the checkpoint restores exactly (`restore_train_state` into the
    placed state, and `restore(step, shardings=)` of `NamedSharding`s
    straight onto the mesh), and a 2 x 2 run restored from it (elastic
    reshard) continues with the uninterrupted run's loss.
"""
import dataclasses
import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_mesh_worker
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.dist.compression import init_error_feedback
from repro.serve import engine as RE
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.train_step import init_train_state as ref_init, make_train_step as ref_make
from repro_torch.configs import get_config
from repro_torch.dist.sharding import P
from test_torch_train_step import (B, OPT, S, STEP_METRICS, TOL_PARAM, Run, _widen, check_params, check_steps,
                                   flat, rounded_once, with_memory)
from test_torch_train_cases import TOL_GNORM_INT8, TOL_PARAM_INT8, check_residuals
from test_torch_train_step_jamba import NOISE_SEEDS, PARAM_TOL_JAMBA, SPREAD_FACTOR, TOL_GNORM_JAMBA

WORLD, CHUNK, STEPS, NEW = 4, 8, 3, 5
# jamba cut to one period of its reduced config (8 of 16 layers: Mamba,
# attention, MoE and MLP all in it) to keep the ranks' collectives few
JAMBA = {"n_layers": 8}
VARIANT = {"n_heads": 6, "n_kv_heads": 3, "vocab": 250}
# (name, mesh, arch, overrides of the reduced config in both packages, step options, batch)
TRAIN = [
    # 2 microbatches of tests/test_torch_train_step.py's batch size each
    ("qwen3_fsdp_mb2", (2, 2), "qwen3-0.6b", {"fsdp": True}, {"num_microbatches": 2, "accum_dtype": "float32"}, 2 * B),
    ("qwen3_int8", (2, 2), "qwen3-0.6b", {}, {"compress_grads": True}, B),
    ("phi_moe", (2, 2), "phi3.5-moe-42b-a6.6b", {}, {}, B),
    ("jamba", (2, 2), "jamba-v0.1-52b", JAMBA, {}, B),
    ("whisper_remat", (2, 2), "whisper-large-v3", {"remat": True}, {}, B),
    ("qwen3_indivisible", (1, 4), "qwen3-0.6b", VARIANT, {}, B),
]
SERVE = [  # (name, mesh, the train case whose config and initial parameters it serves)
    ("serve_jamba", (2, 2), "jamba"),
    ("serve_indivisible", (1, 4), "qwen3_indivisible"),
]
PROMPT, MARGIN = (4, 16), 3  # B, S; S + NEW + MARGIN = 24 cache rows, which the 4-way model axis divides
LAUNCH = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch", "8", "--seq", "32",
          "--attn-chunk", "8", "--log-every", "100", "--ckpt-every", "2", "--warmup", "2", "--compress-grads"]
TOL_LAUNCH = 1e-6  # relative: the same state, summed on other meshes (measured 2.6e-7)
REF_THREADS, RANKS_TIMEOUT_S = 2, 600
SAVED = "qwen3_fsdp_mb2"  # the train case whose final state the ranks also save
COUNTED = "qwen3_fsdp_mb2"  # ... and whose first step's collectives they count, for the dry run's
# overrides under which the reference's init_train_state draws the same state
SAME_INIT = ("fsdp",)
TOL_EMBED = 1e-6  # absolute: the gathers are exact, the gradient sums the same terms


def ref_cfg(arch: str, overrides: dict):
    return dataclasses.replace(ref_get_config(arch).reduced(), **overrides)


def port_cfg(arch: str, overrides: dict):
    return dataclasses.replace(get_config(arch).reduced(), **overrides)


def serve_batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    B, S = PROMPT
    return {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}


def init_key(case: tuple) -> tuple:
    name, mesh, arch, over, kw, rows = case
    return arch, tuple(sorted((k, v) for k, v in over.items() if k not in SAME_INIT))


def initial_state(key: tuple):
    """The reference's `init_train_state(PRNGKey(0), ...)` (jitted) for an
    `init_key`."""
    arch, over = key
    rcfg = ref_cfg(arch, dict(over))
    return jax.jit(lambda k: ref_init(k, rcfg, RefAdamW(**OPT)))(jax.random.PRNGKey(0))


def jobs(tmp, inits: dict):
    """The ranks' cases in order, each with what the reference needs for it
    (None for a case the ranks alone check), as soon as its initial state
    is drawn: a train case carries it as numpy, with the zeroed residual
    of `init_train_state(compress_grads=True)` where it compresses."""
    ref = {}
    for name, mesh, arch, over, kw, rows in TRAIN:
        rcfg, cfg = ref_cfg(arch, over), port_cfg(arch, over)
        state = inits[init_key((name, mesh, arch, over, kw, rows))].result()
        if kw.get("compress_grads"):
            state = type(state)(state.params, init_error_feedback(state.opt, state.params), state.rng)
        init = jax.tree.map(np.asarray, state)
        pipe = RefPipeline(cfg.vocab, S, rows, seed=0)
        bs = [with_memory(cfg, pipe.batch(i), 0, i) for i in range(STEPS)]
        case = {"kind": "train", "name": name, "mesh": mesh, "arch": arch, "overrides": over, "opt": OPT,
                "init": init, "batches": bs, "chunk": CHUNK, "step_kw": kw}
        if name == SAVED:
            case["save_dir"] = str(tmp / "saved")
        if name == COUNTED:
            case["count_collectives"] = True
        ref[name] = ("train", rcfg, cfg, state, init, bs, kw)
        yield case, ref[name]
    for name, mesh, of in SERVE:
        _, rcfg, cfg, state, init, _, _ = ref[of]
        arch, over = next((t[2], t[3]) for t in TRAIN if t[0] == of)
        yield ({"kind": "serve", "name": name, "mesh": mesh, "arch": arch, "overrides": over,
                "params": init.params, "batch": serve_batch(rcfg), "new_tokens": NEW, "margin": MARGIN,
                "chunk": CHUNK}, ("serve", rcfg, state.params, serve_batch(rcfg)))
    yield {"kind": "embed", "name": "embed_fallback", "mesh": (2, 2), "spec": P(None, "model"),
           "shape": (250, 16, 4, 8)}, None
    full, restored = tmp / "ckpt_full", tmp / "ckpt_restored"
    yield {"kind": "launch", "name": "launch_1x4", "mesh": (1, 4),
           "argv": LAUNCH + ["--steps", "3", "--mesh-data", "1", "--mesh-model", "4", "--ckpt-dir", str(full)]}, None
    yield {"kind": "launch", "name": "launch_2x2_restored", "mesh": (2, 2), "copy": (str(full), str(restored)),
           "argv": LAUNCH + ["--steps", "3", "--mesh-data", "2", "--mesh-model", "2",
                             "--ckpt-dir", str(restored)]}, None


def _write(path, obj) -> None:
    with open(path.with_suffix(".tmp"), "wb") as f:
        pickle.dump(obj, f)
    path.with_suffix(".tmp").rename(path)


def reference(case: tuple):
    """The reference's NOPLAN result for one case: a serve case's greedy
    tokens; a train case's steps and final parameters, and for jamba its
    own spread (its parameters' largest gap when its start is moved by one
    rounding, per NOISE_SEEDS of tests/test_torch_train_step_jamba.py)."""
    if case[0] == "serve":
        _, rcfg, params, batch = case
        return np.asarray(RE.generate(params, jax.tree.map(jnp.asarray, batch), rcfg, max_new_tokens=NEW,
                                      cache_margin=MARGIN, attn_chunk=CHUNK))
    _, rcfg, cfg, state, init, bs, kw = case
    step = jax.jit(ref_make(rcfg, RefAdamW(**OPT), attn_chunk=CHUNK, **kw))

    def steps_from(st):
        out = []
        for b in bs:
            st, m = step(st, jax.tree.map(jnp.asarray, b))
            out.append({k: float(m[k]) for k in STEP_METRICS})
        return st, out

    final, steps = steps_from(state)
    want = {"params": flat(final.params)}
    if "ef" in final.opt:
        want["ef"] = flat(final.opt["ef"])
    spread: dict = {}
    if rcfg.family == "hybrid":
        for seed in NOISE_SEEDS:
            moved = type(state)(rounded_once(init.params, seed), state.opt, state.rng)
            _widen(spread, flat(steps_from(moved)[0].params), want["params"])
    return steps, want, spread


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the ranks, draw the initial states (a few at a time: XLA
    compiles outside the GIL) and hand the ranks each case as soon as its
    state is drawn, run the reference meanwhile, join the ranks."""
    tmp = tmp_path_factory.mktemp("mesh")
    t0 = time.perf_counter()
    ctx = mp.start_processes(torch_mesh_worker.run, args=(WORLD, str(tmp)), nprocs=WORLD, join=False,
                             start_method="spawn")
    with ThreadPoolExecutor(REF_THREADS) as pool:
        inits = {}
        for case in TRAIN:
            if init_key(case) not in inits:
                inits[init_key(case)] = pool.submit(initial_state, init_key(case))
        ref, pending = {}, {}
        for i, (case, need) in enumerate(jobs(tmp, inits)):
            _write(tmp / f"case_{i:02d}.pkl", case)
            if need is not None:
                ref[case["name"]] = need
                pending[case["name"]] = pool.submit(reference, need)
        (tmp / "cases_end").write_text(str(i + 1))
        want = {k: f.result() for k, f in pending.items()}
    t_ref = time.perf_counter() - t0
    while not ctx.join(timeout=1):
        if time.perf_counter() - t0 > RANKS_TIMEOUT_S:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the mesh ranks did not finish in {RANKS_TIMEOUT_S} s")
    with open(tmp / "results.pkl", "rb") as f:
        got = pickle.load(f)
    print(f"reference {t_ref:.1f} s, ranks {time.perf_counter() - t0:.1f} s")
    return got, want, ref


def as_run(name: str, ref: dict, want: dict) -> Run:
    _, rcfg, cfg, state, init, bs, kw = ref[name]
    steps, final, _ = want[name]
    return Run(cfg.name, cfg, init, bs, None, None, None, steps, final)


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_mesh_train_steps_match_reference(runs, name):
    """jamba, as in tests/test_torch_train_step_jamba.py: its named bounds,
    or SPREAD_FACTOR times the reference's own spread where that is more."""
    got, want, ref = runs
    run = as_run(name, ref, want)
    mine = got[name]
    final = {"params": flat(mine["final"]["params"])}
    if run.arch == "jamba-v0.1-52b":
        spread = want[name][2]
        check_steps(run, mine["steps"], tol={"grad_norm": TOL_GNORM_JAMBA})
        named = {(run.arch, k): max(PARAM_TOL_JAMBA.get(k, TOL_PARAM), SPREAD_FACTOR * spread[k]) for k in spread}
        check_params(run, final, named=named)
    elif "ef" in run.final:  # int8 error feedback, as tests/test_torch_train_cases.py holds it
        check_steps(run, mine["steps"], tol={"grad_norm": TOL_GNORM_INT8})
        check_params(run, final, tol=TOL_PARAM_INT8, named={})
        check_residuals(run, {"ef": flat(mine["final"]["opt"]["ef"])})
    else:
        check_steps(run, mine["steps"])
        check_params(run, final)


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_mesh_state_is_placed_by_its_specs(runs, name):
    got, _, _ = runs
    assert got[name]["n_checked"] > 0
    assert got[name]["misplaced"] == []


@pytest.mark.parametrize("name", [s[0] for s in SERVE])
def test_mesh_serve_tokens_match_reference(runs, name):
    """And the KV cache at its spec: head-sharded where the model axis
    divides KVH (jamba's 2 on 2), else sequence-sharded (3 on 4); zeroed
    caches placed by `convert.distribute_caches` at prefill's placements."""
    got, want, _ = runs
    np.testing.assert_array_equal(got[name]["tokens"], want[name])
    assert got[name]["kv_placements"] == ("(Replicate(), Shard(dim=1))" if name == "serve_indivisible"
                                          else "(Shard(dim=0), Shard(dim=2))")
    assert got[name]["cache_placements_differ"] == []  # convert.distribute_caches places them alike


def test_mesh_save_gathers_one_leaf_at_a_time(runs):
    """`save_train_state` on the mesh gathers every DTensor leaf whole, and
    each is freed before the next is gathered: peak device memory of a
    save is the state's shards plus one whole leaf."""
    got, _, _ = runs
    save = got[SAVED]["save"]
    assert save["gathered"] == save["dtensor_leaves"] > 0
    assert save["most_alive"] == 1


def test_embedding_fallback_layout(runs):
    got, _, _ = runs
    r = got["embed_fallback"]
    assert "Shard(dim=1)" in r["table_placements"]
    assert r["fwd_gap"] == 0.0
    assert r["grad_gap"] <= TOL_EMBED


def test_launcher_elastic_restore_continues(runs):
    """The 2 x 2 run restores the 1 x 4 run's step-2 checkpoint exactly
    (every leaf, gathered, equals the saved one) and its step-2 loss is the
    1 x 4 run's, up to the two meshes' summation orders."""
    got, _, _ = runs
    whole, restored = got["launch_1x4"], got["launch_2x2_restored"]
    assert whole["rc"] == restored["rc"] == 0
    assert len(whole["losses"]) == 3 and len(restored["losses"]) == 1
    assert restored["restore_max_gap"] == 0.0 and restored["restored_leaves"] > 0
    assert restored["misplaced_restore"] == []
    np.testing.assert_allclose(restored["losses"], whole["losses"][2:], rtol=TOL_LAUNCH)


def test_dry_run_counts_the_ranks_collectives(runs):
    """The dry run of the 2 x 2 qwen3 fsdp case's step (meta DTensors on a
    fake 2 x 2 group in this process, `launch.dryrun.trace_cell`) issues
    the collectives the gloo ranks' first step issued, kind for kind.  On a
    "cpu" mesh, as gloo's; on a "cuda" one DTensor sends an all-to-all
    where gloo, which has none, gathers and chunks."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist.sharding import make_plan
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    got, _, _ = runs
    ranks: dict = {}
    for op, n in got[COUNTED]["collectives"].items():
        ranks[D.collective_kind(op)] = ranks.get(D.collective_kind(op), 0) + n
    assert ranks and None not in ranks
    name, mesh_shape, arch, over, kw, rows = next(t for t in TRAIN if t[0] == COUNTED)
    cfg, opt = port_cfg(arch, over), AdamWConfig(**OPT)
    counts = {}
    with D.fake_process_group(WORLD):
        for device_type in ("cpu", "cuda"):
            plan = make_plan(make_host_mesh(*mesh_shape, device_type=device_type), cfg)
            args = (D.abstract_train_state(cfg, opt, plan), D.abstract_batch(cfg, ShapeConfig("t", S, rows, "train"), plan))
            step = make_train_step(cfg, opt, plan, attn_chunk=CHUNK, **kw)
            counts[device_type] = {k: c["count"] for k, c in D.trace_cell(step, args)["collectives"].items()}
    assert counts["cpu"] == ranks
    renamed = dict(counts["cuda"])
    renamed["all-gather"] = renamed.get("all-gather", 0) + renamed.pop("all-to-all", 0)
    assert renamed == ranks
