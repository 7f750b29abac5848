"""The port's LM sharding rules against the JAX package's, entry by entry,
as pure spec logic: duck-typed meshes (as tests/test_sharding.py uses) and
no process group.

For all ten configs at full size, fsdp off and on, on the single-pod
16 x 16 ("data", "model") mesh and the multi-pod 2 x 16 x 16 ("pod",
"data", "model") mesh:
  * parameter specs (`param_pspecs` + `valid_spec`): a layer's spec is the
    reference's spec of its stacked leaf without the stack entry, and the
    stack entry is None but for the stacked column-parallel vectors under
    fsdp named in STACK_ENTRY_NAMED (the port keeps layers apart, so it
    replicates those over the data axes);
  * `opt_pspecs` with factored_v off and on, `cache_pspecs`, `batch_specs`
    / `batch_pspecs` for every SHAPES entry and the activation spec
    methods;
and `make_plan`, `valid_spec`, `placements`, `dp_size` and `MESH_SHAPES`.
"""
import functools

import jax
import numpy as np
import pytest
from jax.tree_util import keystr, tree_flatten_with_path

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as RS
from repro.launch import mesh as RM
from repro.models import transformer as RT
from repro.serve import engine as RE
from repro.train import optimizer as RO
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.dist import sharding as S
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E
from repro_torch.train import optimizer as O
from repro_torch.train.stacks import reference_leaves
from repro_torch.train.train_step import master_leaves
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = list_configs()
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
# (arch, mesh): the reference leaves whose stack entry names the data axes
# (fsdp on): layer-stacked column-parallel vectors, whose stacked rank puts
# them under the matrix rule P(fsdp, tp) there; kept where the layer count
# divides the data axes (48 mamba2 layers do not divide 32).
STACK_ENTRY_NAMED = {
    ("mamba2-370m", "single"): {"blocks.0.mamba.conv_b"},
    ("minitron-4b", "single"): {"blocks.0.mlp.bu"},
    ("minitron-4b", "multi"): {"blocks.0.mlp.bu"},
    ("whisper-large-v3", "single"): {"blocks.0.mlp.bu", "encoder.blocks.mlp.bu"},
    ("whisper-large-v3", "multi"): {"blocks.0.mlp.bu", "encoder.blocks.mlp.bu"},
}
N_HEADS = (1, 2, 8, 12, 16, 20, 32, 48)


class FakeMesh:
    """Duck-typed mesh: `.shape` and `.axis_names` (the reference's rules),
    `.mesh_dim_names` and `.size(i)` (the port's placements)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = self.mesh_dim_names = tuple(shape)

    def size(self, i: int) -> int:
        return self.shape[self.axis_names[i]]


def norm(spec) -> tuple:
    """A spec as a plain tuple, 1-tuples as their name (JAX's own form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else (tuple(e) if isinstance(e, tuple) else e)
                 for e in spec)


def plans(mesh_name: str, fsdp: bool, sp: bool = False):
    mesh = FakeMesh(MESHES[mesh_name])

    class Cfg:
        pass

    cfg = Cfg()
    cfg.fsdp = fsdp
    return RS.make_plan(mesh, cfg, sp=sp), S.make_plan(mesh, cfg, sp=sp)


@functools.lru_cache(maxsize=None)
def ref_abstract(arch: str):
    return RT.abstract_params(ref_get_config(arch))


@functools.lru_cache(maxsize=None)
def port_abstract(arch: str):
    return T.abstract_params(get_config(arch))


def dotted(path) -> str:
    return keystr(path).replace("['", ".").replace("']", "").replace("[", ".").replace("]", "").lstrip(".")


def ref_param_specs(arch: str, plan) -> dict:
    """{reference leaf name: (valid spec, shape)}."""
    out = {}
    for path, leaf in tree_flatten_with_path(ref_abstract(arch))[0]:
        keys = tuple(p.key if hasattr(p, "key") else str(p) for p in path)
        spec = RS.valid_spec(tuple(leaf.shape), RS._leaf_spec(keys, tuple(leaf.shape), plan), plan.mesh)
        out[dotted(path)] = (norm(spec), tuple(leaf.shape))
    return out


def port_param_specs(arch: str, plan) -> dict:
    """{the port's parameter name: valid spec}."""
    params = port_abstract(arch)
    specs = S.param_pspecs(params, plan)
    return {k: norm(S.valid_spec(tuple(t.shape), specs[k], plan.mesh)) for k, t in params.named_parameters()}


def reference_name(name: str, period: int) -> tuple[str, bool]:
    """The reference's leaf name of the port's parameter, and whether it is
    one layer of a stacked leaf."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return f"blocks.{int(parts[1]) % period}.{'.'.join(parts[2:])}", True
    if parts[:2] == ["encoder", "blocks"]:
        return f"encoder.blocks.{'.'.join(parts[3:])}", True
    return name, False


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, fsdp, mesh_name):
    rplan, plan = plans(mesh_name, fsdp)
    ref, mine = ref_param_specs(arch, rplan), port_param_specs(arch, plan)
    period = get_config(arch).period
    named, seen = set(), set()
    for name, spec in mine.items():
        rname, layer = reference_name(name, period)
        rspec, rshape = ref[rname]
        seen.add(rname)
        if layer:
            assert spec == rspec[1:], (name, spec, rspec)
            if rspec[0] is not None:
                named.add(rname)
        else:
            assert spec == rspec, (name, spec, rspec)
    assert seen == set(ref)
    assert named == (STACK_ENTRY_NAMED.get((arch, mesh_name), set()) if fsdp else set())


def ref_leaf_specs(arch: str, plan) -> dict:
    """The reference's valid parameter specs as its tree."""
    specs = ref_param_specs(arch, plan)
    flat, tdef = tree_flatten_with_path(ref_abstract(arch))
    return jax.tree_util.tree_unflatten(tdef, [jax.sharding.PartitionSpec(*specs[dotted(p)][0]) for p, _ in flat])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_pspecs_match_reference(arch, factored, fsdp, mesh_name):
    rplan, plan = plans(mesh_name, fsdp)
    ref = RO.opt_pspecs(ref_abstract(arch), ref_leaf_specs(arch, rplan), RO.AdamWConfig(factored_v=factored))
    cfg = get_config(arch)
    params = port_abstract(arch)
    valid = {k: S.valid_spec(tuple(t.shape), s, plan.mesh)
             for (k, t), s in zip(params.named_parameters(), S.param_pspecs(params, plan).values())}
    mine = O.opt_pspecs(master_leaves(params, cfg), reference_leaves(valid, cfg.period),
                        O.AdamWConfig(factored_v=factored))
    assert norm(mine["step"]) == norm(ref["step"]) == ()
    rflat = {dotted(p): norm(s) for p, s in tree_flatten_with_path(
        {"m": ref["m"], "v": ref["v"]}, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    checked = 0
    for part in ("m", "v"):
        for name, leaf in mine[part].items():
            if isinstance(leaf, dict) and set(leaf) == {"r", "c"}:  # one factored pair of a stack of vectors
                assert norm(leaf["r"])[1:] == rflat[f"{part}.{name}.r"][1:], name
                assert norm(leaf["c"]) == rflat[f"{part}.{name}.c"], name
                checked += 1
                continue
            for spec in (leaf if isinstance(leaf, list) else [leaf]):
                stacked = isinstance(leaf, list)
                if isinstance(spec, dict):
                    for k in ("r", "c"):
                        want = rflat[f"{part}.{name}.{k}"]
                        assert norm(spec[k]) == (want[1:] if stacked else want), (name, k)
                else:
                    want = rflat[f"{part}.{name}"]
                    assert norm(spec) == (want[1:] if stacked else want), name
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch, fsdp, mesh_name):
    """Layer i's specs are period position i % period's without the
    reference's leading n_reps entry."""
    rplan, plan = plans(mesh_name, fsdp)
    cfg = get_config(arch)
    ref = RE.cache_pspecs(ref_get_config(arch), rplan)
    mine = E.cache_pspecs(cfg, plan)
    assert len(mine) == cfg.n_layers
    for i, layer in enumerate(mine):
        want = ref[i % cfg.period]
        assert sorted(layer) == sorted(want)
        for k, spec in layer.items():
            assert norm(want[k])[0] is None
            assert norm(spec) == norm(want[k])[1:], (i, k)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch, shape):
    for mesh_name, fsdp in ((m, f) for m in MESHES for f in (False, True)):
        rplan, plan = plans(mesh_name, fsdp)
        ref = RS.batch_specs(ref_get_config(arch), REF_SHAPES[shape], rplan)
        mine = S.batch_specs(get_config(arch), SHAPES[shape], plan)
        assert sorted(mine) == sorted(ref)
        for k, t in mine.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape) and str(t.dtype).split(".")[-1] == str(ref[k].dtype), k
        rp = RS.batch_pspecs(ref_get_config(arch), REF_SHAPES[shape], rplan)
        mp = S.batch_pspecs(get_config(arch), SHAPES[shape], plan)
        assert {k: norm(v) for k, v in mp.items()} == {k: norm(v) for k, v in rp.items()}


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_specs_and_plan_match_reference(mesh_name, fsdp, sp):
    rplan, plan = plans(mesh_name, fsdp, sp)
    assert (plan.dp, plan.tp, plan.fsdp, plan.sp) == (rplan.dp, rplan.tp, rplan.fsdp, rplan.sp)
    assert (plan.tp_size(), plan.dp_size(), plan.data_axes()) == (rplan.tp_size(), rplan.dp_size(), rplan.data_axes())
    for m in ("hidden", "memory", "logits", "ssm_state", "conv_state", "stream"):
        assert norm(getattr(plan, m)()) == norm(getattr(rplan, m)()), m
    for h in N_HEADS:
        assert norm(plan.scores(h)) == norm(rplan.scores(h)), h
        assert norm(plan.kv_cache(h)) == norm(rplan.kv_cache(h)), h
    assert norm(S.NOPLAN.hidden()) == norm(RS.NOPLAN.hidden()) and S.NOPLAN.dp_size() == 1


def test_valid_spec_matches_reference():
    """tests/test_sharding.py's cases, and every entry kind on both meshes."""
    mesh = FakeMesh(MESHES["single"])
    P = S.P
    assert S.valid_spec((1, 524_288), P("data", "model"), mesh) == P(None, "model")
    assert S.valid_spec((256, 100), P("data", "model"), mesh) == P("data", None)
    assert S.valid_spec((32,), P(("data", "model"),), mesh) == P(None)
    assert S.valid_spec((512,), P(("data", "model"),), mesh) == P(("data", "model"))
    assert S.valid_spec((4, 5), None, mesh) == P(None, None)
    rng = np.random.default_rng(0)
    entries = [None, "data", "model", ("data", "model")]
    for _ in range(200):
        nd = int(rng.integers(1, 4))
        shape = tuple(int(rng.choice([1, 2, 16, 32, 48, 256, 51_866])) for _ in range(nd))
        spec = tuple(entries[int(rng.integers(0, 4))] for _ in range(nd))
        assert norm(S.valid_spec(shape, S.P(*spec), mesh)) == norm(
            RS.valid_spec(shape, jax.sharding.PartitionSpec(*spec), mesh)), (shape, spec)


def test_whisper_vocab_fallback():
    """The embedding rule's fallback (tests/test_sharding.py): a vocabulary
    the model axis does not divide puts TP on d_model."""
    _, plan = plans("single", False)
    assert S._leaf_spec(("embed",), (51_866, 1280), plan) == S.P(None, "model")
    assert S._leaf_spec(("embed",), (51_968, 1280), plan) == S.P("model", None)


def test_placements():
    """One placement per mesh dim; a tuple entry shards one dim over both
    axes in the mesh's order; an axis of one device replicates; an axis
    named twice raises."""
    from torch.distributed.tensor import Replicate, Shard

    multi = FakeMesh(MESHES["multi"])
    assert S.placements(S.P(("pod", "data"), None, "model"), multi) == (Shard(0), Shard(0), Shard(2))
    assert S.placements(S.P(None, "data"), multi) == (Replicate(), Shard(1), Replicate())
    assert S.placements(S.P(), multi) == (Replicate(),) * 3
    assert S.placements(S.P("model", "data"), FakeMesh({"data": 1, "model": 4})) == (Replicate(), Shard(0))
    with pytest.raises(ValueError, match="twice"):
        S.placements(S.P("data", "data"), multi)


def test_mesh_shapes_and_dp_size():
    assert M.MESH_SHAPES == RM.MESH_SHAPES
    for shape in MESHES.values():
        assert M.dp_size(FakeMesh(shape)) == RM.dp_size(FakeMesh(shape))
    with pytest.raises(RuntimeError, match="process group"):
        M.make_host_mesh(1, 1)


def test_shard_is_identity_off_a_mesh():
    import torch

    x = torch.ones(2, 3)
    assert S.shard(x, S.P("data", None), S.NOPLAN) is x
    assert S.place(x, S.P("data", None), S.NOPLAN) is x
    assert S.local_call(lambda t: t + 1, S.NOPLAN, [x], [None], None).sum() == 12
