"""The port's dry run against the JAX package's: argument bytes.

For the ten full configs x train / prefill / decode x both production
meshes, rank 0's local shards of the port's `build_cell` arguments (meta
DTensors over a fake 256- or 512-rank group), leaf by leaf, against the
reference dry run's per-device bytes of the same leaves: its
`jax.eval_shape` shapes under its `param_pspecs` / `opt_pspecs` /
`cache_pspecs` / batch specs, each divided by the axis sizes of its
sharded dims.  Equal but for the layer-stacked leaves whose stack entry
the reference shards over the data axes
(`test_torch_mesh_specs.STACK_ENTRY_NAMED`), which the port replicates.
"""
import dataclasses
import functools

import jax
import pytest
import torch.distributed as dist
from jax.tree_util import tree_flatten_with_path

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as RS
from repro.models import transformer as RT
from repro.serve import engine as RE
from repro.train import optimizer as RO
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.train.train_step import master_leaves
from test_torch_mesh_specs import MESHES, STACK_ENTRY_NAMED, FakeMesh, dotted
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = list_configs()
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized(), "a test left a process group running"


def _local_bytes(shape, spec, mesh) -> int:
    """Rank 0's bytes-per-element count of a leaf under a valid spec:
    each sharded dim divided by its axes' sizes, rounded up."""
    n = 1
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, entry in zip(shape, entries):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        size = 1
        for a in names:
            size *= mesh.shape[a]
        n *= -(-dim // size)
    return n


def _add(out: dict, category: str, tree, specs, mesh, strip_rc: bool = False) -> None:
    flat_specs = {dotted(p): s for p, s in tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    for path, leaf in tree_flatten_with_path(tree)[0]:
        name = dotted(path)
        spec = RS.valid_spec(tuple(leaf.shape), flat_specs[name], mesh)
        key = name[:-2] if strip_rc and name.endswith((".r", ".c")) else name
        n = _local_bytes(tuple(leaf.shape), spec, mesh) * jax.numpy.dtype(leaf.dtype).itemsize
        out[(category, key)] = out.get((category, key), 0) + n


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, serving: bool):
    """The reference's config and abstract parameters for the cell kind
    (serving: bfloat16 parameters).  The bfloat16 tree is the float32 one
    with param_dtype's leaves retyped: the leaves that follow param_dtype
    are those whose dtype changes with it in the reduced config's two trees
    (an `eval_shape` of the full init costs seconds; the reduced one's
    does not)."""
    cfg = ref_get_config(arch)
    params = _ref_params(arch, False)[1] if serving else RT.abstract_params(cfg)
    if not serving:
        return cfg, params
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    small = ref_get_config(arch).reduced()
    f32 = _dtypes(RT.abstract_params(small))
    bf16 = _dtypes(RT.abstract_params(dataclasses.replace(small, param_dtype="bfloat16")))
    retyped = {name for name in f32 if f32[name] != bf16[name]}
    assert all(bf16[name] == jax.numpy.bfloat16 for name in retyped)
    flat, tdef = tree_flatten_with_path(params)
    return cfg, jax.tree_util.tree_unflatten(tdef, [
        jax.ShapeDtypeStruct(leaf.shape, jax.numpy.bfloat16 if dotted(path) in retyped else leaf.dtype)
        for path, leaf in flat])


def _dtypes(tree) -> dict:
    return {dotted(path): leaf.dtype for path, leaf in tree_flatten_with_path(tree)[0]}


def ref_bytes(arch: str, kind: str, mesh_name: str) -> dict:
    """{(category, leaf name): rank 0's bytes} of the reference dry run's
    arguments for the cell, as its `build_cell` shapes and shards them."""
    cfg, params = _ref_params(arch, kind != "train")
    mesh = FakeMesh(MESHES[mesh_name])
    plan = RS.make_plan(mesh, cfg)
    shape = REF_SHAPES[KINDS[kind]]
    p_specs = RS.param_pspecs(params, plan)
    out: dict = {}
    _add(out, "params", params, p_specs, mesh)
    _add(out, "batch", RS.batch_specs(cfg, shape, plan), RS.batch_pspecs(cfg, shape, plan), mesh)
    if kind == "train":
        opt_cfg = RO.AdamWConfig(state_dtype="bfloat16" if cfg.fsdp else "float32", factored_v=cfg.fsdp)
        valid = jax.tree.map(lambda a, s: RS.valid_spec(a.shape, s, mesh), params, p_specs,
                             is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        opt = jax.eval_shape(functools.partial(RO.adamw_init, cfg=opt_cfg), params)
        o_specs = RO.opt_pspecs(params, valid, opt_cfg)
        for part in ("m", "v"):
            _add(out, part, opt[part], o_specs[part], mesh, strip_rc=True)
        _add(out, "step", {"step": opt["step"]}, {"step": o_specs["step"]}, mesh)
    if kind == "decode":
        caches = RE.cache_specs(cfg, shape.global_batch, shape.seq_len)
        _add(out, "cache", caches, RE.cache_pspecs(cfg, plan), mesh)
    return out


def port_bytes(arch: str, kind: str, mesh_name: str) -> dict:
    """The same, from the local shards of the port's `build_cell`
    arguments (caches named by period position, as the reference stacks
    them)."""

    def bytes_of(leaf) -> int:
        if isinstance(leaf, dict):
            return sum(bytes_of(v) for v in leaf.values())
        if isinstance(leaf, list):
            return sum(bytes_of(v) for v in leaf)
        return D._local(leaf).untyped_storage().nbytes()

    with D.fake_process_group(512 if mesh_name == "multi" else 256):
        mesh = M.make_production_mesh(multi_pod=mesh_name == "multi")
        _, args, info = D.build_cell(arch, KINDS[kind], mesh)
        cfg = info["cfg"]
        out: dict = {}
        if kind == "train":
            state, batch = args
            params, caches = state.params, []
            for part in ("m", "v"):
                out.update({(part, k): bytes_of(v) for k, v in state.opt[part].items()})
            out[("step", "step")] = bytes_of(state.opt["step"])
        elif kind == "prefill":
            params, batch = args
            caches = []
        else:
            params, tokens, pos, caches, memory = args
            batch = dict(memory, tokens=tokens, pos=pos)
        out.update({("params", k): bytes_of(v) for k, v in master_leaves(params, cfg).items()})
        out.update({("batch", k): bytes_of(v) for k, v in batch.items()})
        for i, layer in enumerate(caches):
            for k, t in layer.items():
                key = ("cache", f"{i % cfg.period}.{k}")
                out[key] = out.get(key, 0) + bytes_of(t)
        assert all(t.device.type == "meta" for t in D._state_tensors(args))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_reference(arch, kind, mesh_name):
    """Leaf for leaf; the named stacked leaves (fsdp configs) only by
    their own bytes, which the port holds for every data rank."""
    ref, mine = ref_bytes(arch, kind, mesh_name), port_bytes(arch, kind, mesh_name)
    assert sorted(mine) == sorted(ref)
    named = STACK_ENTRY_NAMED.get((arch, mesh_name), set()) if get_config(arch).fsdp else set()
    differ = {k for k in ref if mine[k] != ref[k]}
    assert {name for _, name in differ} <= named, sorted(differ)[:6]
    for key in differ:  # replicated over the data axes where the reference splits the layers
        assert mine[key] > ref[key]
    assert sum(mine.values()) - sum(ref.values()) == sum(mine[k] - ref[k] for k in differ)
