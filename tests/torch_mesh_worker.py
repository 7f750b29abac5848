"""The rank body of tests/test_torch_mesh.py: one process of a gloo group on
the CPU, which imports torch and the port only (the test's own process runs
the reference).

`run(rank, world, job_dir)` joins the group through a FileStore under
`job_dir`, then takes the job's cases one at a time as the test writes
them (`job_dir/case_<i>.pkl`, until `job_dir/cases_end` holds their
count), builds each mesh a case names over the group's ranks, runs the
case on it and, on rank 0, pickles {case name: result} to
`job_dir/results.pkl`.  A case is a dict with a "kind":

  * "train": `make_train_step(cfg, opt, plan, **step_kw)` on the given
    batches from the reference's initial state (numpy); the metrics per
    step, the final state in the reference's layout, and every parameter,
    gradient (as AdamW receives it) and moment whose placements differ
    from its spec's; with "save_dir", `save_train_state` of the final
    state there with its gathers counted; with "count_collectives", the
    collectives of the first step (`CommDebugMode`);
  * "serve": `generate` on the mesh from the reference's parameters, and
    the placements of the caches its prefill made;
  * "embed": the sharded embedding on a table at a given spec, forward and
    gradient, against the plain gather;
  * "launch": `launch.train.main` with the given arguments, its losses.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import pickle
import time
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.convert import distribute_caches, params_from_numpy, train_state_from_numpy, train_state_to_numpy
from repro_torch.dist.sharding import (P, full, is_dtensor, make_plan, param_pspecs, place, placements,
                                       valid_spec)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.stacks import members, reference_leaves


def config(case: dict):
    cfg = get_config(case["arch"]).reduced()
    return dataclasses.replace(cfg, **case.get("overrides", {}))


def _misplaced(tree, specs, mesh, where: str) -> list[str]:
    """Leaves of `tree` that are not DTensors at their spec's placements."""
    if isinstance(specs, P):
        want = placements(valid_spec(tuple(tree.shape), specs, mesh), mesh)
        ok = is_dtensor(tree) and tuple(tree.placements) == want
        return [] if ok else [f"{where}: {getattr(tree, 'placements', 'plain tensor')} != {want}"]
    if isinstance(tree, dict):
        return [m for k in tree for m in _misplaced(tree[k], specs[k], mesh, f"{where}.{k}")]
    return [m for i, (t, s) in enumerate(zip(tree, specs)) for m in _misplaced(t, s, mesh, f"{where}.{i}")]


@contextlib.contextmanager
def _optimizer_input(into: dict):
    """Record the gradient tree each step hands AdamW."""
    real = TS.adamw_update

    def spy(params, grads, state, cfg, shardings=None):
        into.clear()
        into.update(grads)
        return real(params, grads, state, cfg, shardings=shardings)

    TS.adamw_update = spy
    try:
        yield into
    finally:
        TS.adamw_update = real


def train(case: dict, mesh) -> dict:
    """From the reference's initial state (numpy), placed on the mesh."""
    from repro_torch.convert import distribute_train_state, train_state_pspecs

    cfg = config(case)
    plan = make_plan(mesh, cfg)
    opt = AdamWConfig(**case["opt"])
    state = distribute_train_state(train_state_from_numpy(case["init"], cfg, "cpu"), cfg, plan, opt)
    step = TS.make_train_step(cfg, opt, plan, attn_chunk=case["chunk"], **case.get("step_kw", {}))
    steps, grads, collectives = [], {}, None
    with _optimizer_input(grads):
        for i, b in enumerate(case["batches"]):
            with _comm_counts(case.get("count_collectives") and i == 0) as counted:
                state, m = step(state, b)
            if counted is not None:
                collectives = counted
            steps.append({k: float(m[k]) for k in ("loss", "ce", "grad_norm", "lr")})
    specs = train_state_pspecs(state, cfg, plan, opt)
    leaf_specs = reference_leaves(param_pspecs(state.params, plan), cfg.period)
    misplaced = (_misplaced(dict(state.params.named_parameters()), specs["params"], mesh, "params")
                 + _misplaced({k: v for k, v in state.opt.items()}, specs["opt"], mesh, "opt")
                 + _misplaced(grads, leaf_specs, mesh, "grads"))
    n_checked = (len(list(state.params.parameters())) + sum(len(members(g)) for g in grads.values()))
    out = {"steps": steps, "final": train_state_to_numpy(state, cfg), "misplaced": misplaced,
           "n_checked": n_checked, "collectives": collectives}
    if "save_dir" in case:
        out["save"] = _save_gathers(state, case["save_dir"])
    return out


@contextlib.contextmanager
def _comm_counts(on: bool):
    """Where `on`: the collectives issued inside, {printed op: count}
    (`CommDebugMode`), filled in on exit; else None."""
    if not on:
        yield None
        return
    from torch.distributed.tensor.debug import CommDebugMode

    counts: dict = {}
    with CommDebugMode() as mode:
        yield counts
    counts.update({str(op): n for op, n in mode.get_comm_counts().items()})


def _save_gathers(state, directory: str) -> dict:
    """`save_train_state` of a placed state, with the whole leaves it
    gathers (`full` of a DTensor) counted: how many, and the most alive at
    once (the one being gathered included)."""
    from repro_torch.train import checkpoint as C

    real, alive, stats = C.full, [], {"gathered": 0, "most_alive": 0}

    def spy(t):
        out = real(t)
        if out is not t:
            alive[:] = [r for r in alive if r() is not None] + [weakref.ref(out)]
            stats["gathered"] += 1
            stats["most_alive"] = max(stats["most_alive"], len(alive))
        return out

    C.full = spy
    try:
        C.save_train_state(C.CheckpointManager(directory), 1, state)
    finally:
        C.full = real
    stats["dtensor_leaves"] = sum(is_dtensor(t) for t in state.params.parameters()) + sum(
        is_dtensor(t) for _, t in _flat(state.opt))
    return stats


@contextlib.contextmanager
def _prefill_caches(into: list):
    """Record the caches each prefill step makes."""
    real = E.make_prefill_step

    def spy(*args, **kw):
        step = real(*args, **kw)

        def recorded(params, batch):
            logits, caches = step(params, batch)
            into.append(caches)
            return logits, caches

        return recorded

    E.make_prefill_step = spy
    try:
        yield into
    finally:
        E.make_prefill_step = real


def serve(case: dict, mesh) -> dict:
    """From the reference's parameters (numpy), placed on the mesh."""
    from repro_torch.convert import distribute_params

    cfg = config(case)
    plan = make_plan(mesh, cfg)
    params = distribute_params(params_from_numpy(case["params"], cfg, "cpu"), plan)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in case["batch"].items()}
    with _prefill_caches([]) as made:
        toks = E.generate(params, batch, cfg, max_new_tokens=case["new_tokens"], cache_margin=case["margin"],
                          plan=plan, attn_chunk=case["chunk"], device="cpu")
    (caches,) = made
    cache_len = batch["tokens"].shape[1] + case["new_tokens"] + case["margin"]
    kv = next(c["k"] for c in caches if "k" in c)
    # zeroed caches placed by cache_pspecs land where prefill puts its own
    placed = distribute_caches(T.init_caches(cfg, batch["tokens"].shape[0], cache_len, device="cpu"), cfg, plan)
    differ = [f"{i}.{k}" for i, (a, b) in enumerate(zip(placed, caches)) for k in a
              if tuple(a[k].placements) != tuple(b[k].placements)]
    return {"tokens": toks.numpy(), "kv_placements": str(kv.placements), "cache_placements_differ": differ}


def embed(case: dict, mesh) -> dict:
    """The sharded embedding's forward and gradient for a table placed at
    `case["spec"]` (the fallback spec of a vocabulary the model axis does
    not divide: d_model over TP), against the plain gather's."""
    from repro_torch.dist.sharding import ShardingPlan

    plan = ShardingPlan(mesh=mesh, dp=("data",), tp="model")
    gen = torch.Generator().manual_seed(0)
    V, D, B, S = case["shape"]
    table = torch.randn((V, D), generator=gen)
    ids = torch.randint(0, V, (B, S), generator=gen)
    g = torch.randn((B, S, D), generator=gen)
    t = place(table, case["spec"], plan).requires_grad_(True)
    x = T._ShardedEmbed.apply(t, place(ids, P("data", None), plan), plan)
    (gt,) = torch.autograd.grad(x, [t], grad_outputs=[place(g, P("data", None, None), plan)])
    tp = table.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(tp[ids], [tp], grad_outputs=[g])
    return {"fwd_gap": float((full(x) - table[ids]).abs().max()), "grad_gap": float((full(gt) - want).abs().max()),
            "table_placements": str(t.placements), "grad_placements": str(gt.placements)}


def launch(case: dict, mesh) -> dict:
    """`launch.train.main`; with "copy": (from, to), rank 0 first copies
    the checkpoint of step 2 from one directory to the other."""
    import shutil

    from repro_torch.launch import train as launch_train

    extra = {}
    if "copy" in case:
        src, dst = (Path(d) for d in case["copy"])
        if dist.get_rank() == 0:
            shutil.copytree(src / "step_00000002", dst / "step_00000002")
        dist.barrier()
        extra = _restore_gap(case["argv"], dst)
    out: dict = {}
    rc = launch_train.main(case["argv"], out)
    return {"rc": rc, "losses": [h["loss"] for h in out["history"]], **extra}


def _restore_gap(argv, ckpt_dir: Path) -> dict:
    """The launcher's state on its mesh with checkpoint step 2 restored
    into it, gathered, against the checkpoint's arrays: the largest gap."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train.checkpoint import CheckpointManager, restore_train_state

    from repro_torch.convert import train_state_pspecs
    from repro_torch.dist.sharding import NamedSharding

    args = launch_train.parse_args(argv)
    mesh = mesh_mod.make_host_mesh(args.mesh_data, args.mesh_model, device_type="cpu")
    cfg, plan, opt_cfg, _, _ = launch_train.build(args, mesh)
    state = TS.init_train_state(cfg, opt_cfg, generator=torch.Generator("cpu").manual_seed(args.seed + 1),
                                device="cpu", compress_grads=args.compress_grads, plan=plan)
    mgr = CheckpointManager(str(ckpt_dir))
    restore_train_state(mgr, state, 2)
    _, saved = mgr.restore(2)
    gaps = [float((full(p).double() - saved["params"][k].double()).abs().max())
            for k, p in state.params.named_parameters()]
    flat_opt = dict(_flat(state.opt))
    for k, v in _flat(saved["opt"]):
        gaps.append(float((full(flat_opt[k]).double() - v.double()).abs().max()))
    # restore(shardings=): the same leaves straight onto the mesh
    specs = train_state_pspecs(state, cfg, plan, opt_cfg)
    named = {"params": {k: NamedSharding(mesh, s) for k, s in specs["params"].items()},
             "opt": _named(specs["opt"], mesh), "rng": "cpu"}
    _, placed = mgr.restore(2, shardings=named)
    want = {f"params.{k}": p.placements for k, p in state.params.named_parameters()}
    want.update({f"opt.{k}": t.placements for k, t in _flat(state.opt)})
    got = dict(_flat({"params": placed["params"], "opt": placed["opt"]}))
    wrong = [k for k, t in got.items() if not is_dtensor(t) or tuple(t.placements) != tuple(want[k])]
    for k, t in _flat(placed["opt"]):
        gaps.append(float((full(t).double() - dict(_flat(saved["opt"]))[k].double()).abs().max()))
    return {"restore_max_gap": max(gaps), "restored_leaves": len(gaps), "misplaced_restore": wrong}


def _named(specs, mesh):
    from repro_torch.dist.sharding import NamedSharding

    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: _named(v, mesh) for k, v in specs.items()}
    return [_named(v, mesh) for v in specs]


def _flat(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


KINDS = {"train": train, "serve": serve, "embed": embed, "launch": launch}


def _cases(job_dir: Path):
    """The job's cases in order, each as soon as the test has written it
    (the test draws the initial states while the ranks run)."""
    for i in itertools.count():
        path, end = job_dir / f"case_{i:02d}.pkl", job_dir / "cases_end"
        while not path.exists():
            if end.exists() and i >= int(end.read_text()):
                return
            time.sleep(0.02)
        with open(path, "rb") as f:
            yield pickle.load(f)


def run(rank: int, world: int, job_dir: str) -> None:
    torch.set_num_threads(1)
    job_dir = Path(job_dir)
    dist.init_process_group("gloo", init_method=f"file://{job_dir / 'store'}", rank=rank, world_size=world)
    meshes: dict = {}
    results = {}
    for case in _cases(job_dir):
        shape = tuple(case["mesh"])
        if case["kind"] != "launch" and shape not in meshes:
            meshes[shape] = mesh_mod.make_host_mesh(*shape, device_type="cpu")
        t0 = time.perf_counter()
        results[case["name"]] = KINDS[case["kind"]](case, meshes.get(shape))
        if rank == 0:
            print("CASE", case["name"], round(time.perf_counter() - t0, 2), flush=True)
    if rank == 0:
        with open(job_dir / "results.pkl", "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
