"""Carry state between the reference package and the port, through numpy,
and place the LM stack's state on a mesh.

Nothing here imports the reference: its arrays arrive as numpy (e.g.
`np.asarray(jax_array)`, `dataclasses.asdict(plan)`), and the port's state
leaves as numpy.  `distribute_params`, `distribute_train_state` and
`distribute_caches` turn a whole tree that every rank holds alike into
DTensors at the spec rules' placements (`repro_torch.dist.sharding`): the
counterpart of the reference's `jax.device_put(tree, shardings)`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.cp_als import CPState
from .core.memctrl import MemoryControllerConfig, config_from_dict
from .core.remap import BlockPlan
from .kernels.workspace import _plan_device_arrays
from .tt.als import TTState
from .tucker.hooi import TuckerState

__all__ = ["factors_from_numpy", "cores_from_numpy", "plan_from_numpy", "config_from_reference",
           "cpstate_to_numpy", "tuckerstate_to_numpy", "ttstate_to_numpy", "params_from_numpy",
           "caches_from_numpy", "caches_to_numpy", "train_state_from_numpy", "train_state_to_numpy",
           "distribute_params", "distribute_train_state", "distribute_caches"]

#: Fields of the reference's configuration that only its TPU VMEM model
#: reads (resident factor tiles, double buffering); the port's kernels
#: have no counterpart.
_TPU_ONLY_FIELDS = {"cache": ("resident_tiles",), "dma": ("buffers",)}


def factors_from_numpy(factors: Sequence[np.ndarray], device: str | torch.device) -> list[torch.Tensor]:
    """Factor matrices as float32 tensors on `device` (copies)."""
    return [torch.tensor(np.asarray(f, np.float32), device=device) for f in factors]


def cores_from_numpy(cores: Sequence[np.ndarray], device: str | torch.device) -> list[torch.Tensor]:
    """TT cores (rl, I, rr) as float32 tensors on `device` (copies)."""
    for k, c in enumerate(cores):
        if np.ndim(c) != 3:
            raise ValueError(f"core {k} has shape {np.shape(c)}; a TT core is (rl, I, rr)")
    return factors_from_numpy(cores, device)


def plan_from_numpy(fields: dict, device: str | torch.device) -> BlockPlan:
    """A reference `BlockPlan`'s fields (its dataclass fields, numpy arrays
    and python scalars) as the port's `BlockPlan` on `device`."""

    def arr(a, dtype):
        return torch.tensor(np.asarray(a, dtype))

    plan = BlockPlan(
        vals=arr(fields["vals"], np.float32),
        iloc=arr(fields["iloc"], np.int32),
        in_locs=tuple(arr(a, np.int32) for a in fields["in_locs"]),
        block_it=arr(fields["block_it"], np.int32),
        block_in=tuple(arr(a, np.int32) for a in fields["block_in"]),
        tile_i=int(fields["tile_i"]),
        in_tiles=tuple(int(t) for t in fields["in_tiles"]),
        blk=int(fields["blk"]),
        out_rows=int(fields["out_rows"]),
        in_rows=tuple(int(r) for r in fields["in_rows"]),
        mode=int(fields["mode"]),
        in_modes=tuple(int(m) for m in fields["in_modes"]),
        nnz=int(fields["nnz"]),
    )
    return _plan_device_arrays(plan, torch.device(device))


def config_from_reference(d: dict) -> MemoryControllerConfig:
    """The reference's `config_to_dict` payload (a plain nested dict) as the
    port's `MemoryControllerConfig`: the same tiles, blk and Remapper
    widths, less the fields only the TPU's VMEM model reads.  Raises
    ValueError on any other field the port does not know."""
    if not isinstance(d, dict):
        raise ValueError(f"config: expected a dict, got {type(d).__name__}")
    ours = {k: ({f: x for f, x in v.items() if f not in _TPU_ONLY_FIELDS.get(k, ())}
                if isinstance(v, dict) else v)
            for k, v in d.items()}
    return config_from_dict(ours)


def cpstate_to_numpy(state: CPState) -> dict:
    """{"factors": [np.ndarray], "lam": np.ndarray, "fit_history": [float]}."""
    return {
        "factors": [f.detach().cpu().numpy() for f in state.factors],
        "lam": state.lam.detach().cpu().numpy(),
        "fit_history": [float(x) for x in state.fit_history],
    }


def tuckerstate_to_numpy(state: TuckerState) -> dict:
    """{"factors": [np.ndarray], "core": np.ndarray, "fit_history": [float]}."""
    return {
        "factors": [f.detach().cpu().numpy() for f in state.factors],
        "core": state.core.detach().cpu().numpy(),
        "fit_history": [float(x) for x in state.fit_history],
    }


def ttstate_to_numpy(state: TTState) -> dict:
    """{"cores": [np.ndarray], "fit_history": [float]}."""
    return {
        "cores": [c.detach().cpu().numpy() for c in state.cores],
        "fit_history": [float(x) for x in state.fit_history],
    }


# ---------------------------------------------------------------------------
# The LM stack: parameter trees and decode caches
# ---------------------------------------------------------------------------


def _tensor(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy leaf as a tensor of `dtype` (default: the leaf's own).
    bfloat16 leaves (numpy's ml_dtypes) pass through float32, which holds
    them exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(dtype or torch.bfloat16)
    t = torch.tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def _leaves(tree, prefix: str = "", is_leaf=lambda node: False):
    """(dotted path, leaf) of every leaf of a nested dict / tuple tree
    (a node for which `is_leaf` holds is a leaf)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.", is_leaf)
    elif isinstance(tree, (tuple, list)):
        for k, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{k}.", is_leaf)
    else:
        yield prefix[:-1], tree


def _unstacked(tree: dict, period: int) -> dict:
    """The reference's parameter leaves under the port's names: repeat r of
    decoder position p is layer r * period + p; encoder repeat r is layer r."""
    out = {}
    for name, leaf in _leaves(tree):
        parts = name.split(".")
        if parts[0] == "blocks":
            pos, rest = int(parts[1]), ".".join(parts[2:])
            for r in range(np.shape(leaf)[0]):
                out[f"blocks.{r * period + pos}.{rest}"] = leaf[r]
        elif parts[:2] == ["encoder", "blocks"]:
            rest = ".".join(parts[2:])
            for r in range(np.shape(leaf)[0]):
                out[f"encoder.blocks.{r}.{rest}"] = leaf[r]
        else:
            out[name] = leaf
    return out


def params_from_numpy(tree: dict, cfg, device: str | torch.device):
    """The reference's parameter tree as numpy (`jax.tree.map(np.asarray,
    params)`: blocks a tuple over period positions, leaves stacked over the
    repeats) as the port's parameters on `device`, layers in depth order.
    Raises ValueError if the trees hold other leaves or shapes."""
    from .models.transformer import abstract_params

    params = abstract_params(cfg).to_empty(device=device)
    named = dict(params.named_parameters())
    leaves = _unstacked(tree, cfg.period)
    if set(leaves) != set(named):
        raise ValueError(f"the reference tree's leaves differ from the port's: only the reference has "
                         f"{sorted(set(leaves) - set(named))[:4]}, only the port "
                         f"{sorted(set(named) - set(leaves))[:4]}")
    with torch.no_grad():
        for name, p in named.items():
            if tuple(np.shape(leaves[name])) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {np.shape(leaves[name])}, the port's {tuple(p.shape)}")
            p.copy_(_tensor(leaves[name], device, p.dtype))
    return params


def caches_from_numpy(tree, cfg, device: str | torch.device) -> list[dict]:
    """The reference's decode caches as numpy (a tuple over period positions
    of dicts, leaves with a leading n_reps dim) as the port's: one dict per
    layer in depth order.  Leaves keep their dtype (bfloat16 included)."""
    period = cfg.period
    return [{k: _tensor(np.asarray(a)[i // period], device) for k, a in tree[i % period].items()}
            for i in range(cfg.n_layers)]


def caches_to_numpy(caches: Sequence[dict], cfg) -> tuple:
    """The port's caches in the reference's layout: a tuple over period
    positions of dicts of numpy arrays stacked over the repeats.  bfloat16
    leaves come out as float32 (numpy has no bfloat16), exactly."""
    period = cfg.period
    out = []
    for pos in range(period):
        layers = [caches[i] for i in range(pos, cfg.n_layers, period)]
        out.append({k: np.stack([(c[k].float() if c[k].dtype == torch.bfloat16 else c[k]).cpu().numpy()
                                 for c in layers])
                    for k in layers[0]})
    return tuple(out)


# ---------------------------------------------------------------------------
# The LM stack: train states
# ---------------------------------------------------------------------------


def _is_rc(x) -> bool:
    return isinstance(x, dict) and set(x) == {"r", "c"}


def _nested(flat: dict) -> dict:
    """The inverse of `_leaves`: nodes whose keys are all indices become
    tuples (the reference's `blocks`)."""
    root: dict = {}
    for name, leaf in flat.items():
        node = root
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def fix(node):
        if not isinstance(node, dict) or _is_rc(node):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return tuple(node[str(i)] for i in range(len(node)))
        return node

    return fix(root)


def _stacked_from_numpy(tree, like: dict, device) -> dict:
    """A reference moment tree (m, v or ef) in the port's layout: keyed by
    leaf name, a layer-stacked leaf split into its layers where the
    parameters `like` are (a factored {r, c} pair of a stack of vectors
    stays whole: its c is shared by the layers)."""
    out = {}
    for name, a in _leaves(tree, is_leaf=_is_rc):
        if name not in like:
            raise ValueError(f"optimizer leaf {name} is not a parameter of this config")
        stack = isinstance(like[name], list)
        if _is_rc(a):
            if stack and like[name][0].dim() >= 2:
                out[name] = [{"r": _tensor(r, device), "c": _tensor(c, device)}
                             for r, c in zip(np.asarray(a["r"]), np.asarray(a["c"]))]
            else:
                out[name] = {"r": _tensor(a["r"], device), "c": _tensor(a["c"], device)}
        else:
            out[name] = [_tensor(x, device) for x in np.asarray(a)] if stack else _tensor(a, device)
    if set(out) != set(like):
        raise ValueError(f"optimizer tree lacks {sorted(set(like) - set(out))[:4]}")
    return out


def _field(state, name: str):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def train_state_from_numpy(state, cfg, device: str | torch.device):
    """The reference's `TrainState` as numpy (`jax.tree.map(np.asarray,
    state)`, or a dict with its fields params, opt, rng) as the port's on
    `device`: the parameters restacked by `params_from_numpy`; m, v (or
    factored r/c), ef split into layers; step as int32.  The port's
    generator is seeded with the reference key's two words (k0 << 32 | k1):
    the same seed, not the same numbers."""
    from .train.train_step import TrainState, master_leaves

    params = params_from_numpy(_field(state, "params"), cfg, device)
    like = master_leaves(params, cfg)
    opt_np = _field(state, "opt")
    opt = {k: _stacked_from_numpy(opt_np[k], like, device) for k in ("m", "v", "ef") if k in opt_np}
    opt["step"] = torch.tensor(np.asarray(opt_np["step"]), dtype=torch.int32, device=device)
    extra = set(opt_np) - {"m", "v", "ef", "step"}
    if extra:
        raise ValueError(f"optimizer state keys {sorted(extra)} are not the port's")
    key = np.asarray(_field(state, "rng")).astype(np.uint64).reshape(-1)
    seed = int((key[0] << np.uint64(32)) | key[-1]) if key.size else 0
    rng = torch.Generator(device).manual_seed(seed)
    return TrainState(params=params, opt={"m": opt.pop("m"), "v": opt.pop("v"), **opt}, rng=rng)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """bfloat16 as float32, exactly; a DTensor gathered whole."""
    from .dist.sharding import full

    t = full(t.detach())
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _stacked_to_numpy(tree: dict) -> dict:
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, list) and leaf and _is_rc(leaf[0]):
            out[name] = {k: np.stack([_numpy(x[k]) for x in leaf]) for k in ("r", "c")}
        elif isinstance(leaf, list):
            out[name] = np.stack([_numpy(x) for x in leaf])
        elif _is_rc(leaf):
            out[name] = {k: _numpy(x) for k, x in leaf.items()}
        else:
            out[name] = _numpy(leaf)
    return _nested(out)


def train_state_to_numpy(state, cfg) -> dict:
    """The port's `TrainState` in the reference's layout as numpy:
    {"params", "opt": {"m", "v", "step"[, "ef"]}, "rng"}; parameters and
    moments stacked over the layer repeats (bfloat16 moments as float32,
    exactly); "rng" is the generator's state bytes."""
    from .train.train_step import master_leaves

    opt = {k: (_stacked_to_numpy(v) if k != "step" else _numpy(v)) for k, v in state.opt.items()}
    return {"params": _stacked_to_numpy(master_leaves(state.params, cfg)), "opt": opt,
            "rng": state.rng.get_state().numpy()}


# ---------------------------------------------------------------------------
# The LM stack on a mesh
# ---------------------------------------------------------------------------


def distribute_params(params, plan):
    """Replace every parameter of a `Params` tree, in place, by a DTensor at
    its `param_pspecs` placement (divisibility-filtered): each rank keeps
    its shards of the whole tensor it holds, nothing is communicated.
    Returns `params`."""
    from torch import nn

    from .dist.sharding import param_pspecs, place

    specs = param_pspecs(params, plan)
    for mod_name, mod in params.named_modules():
        for name, p in list(mod._parameters.items()):
            full_name = f"{mod_name}.{name}" if mod_name else name
            mod._parameters[name] = nn.Parameter(place(p.detach(), specs[full_name], plan), requires_grad=False)
    return params


def _place_tree(tree, specs, plan):
    """`tree` (dicts, lists, tensors) placed leaf by leaf by the matching
    spec of `specs` (the same structure, a `PartitionSpec` at each leaf)."""
    from .dist.sharding import PartitionSpec, place

    if isinstance(specs, PartitionSpec):
        return place(tree, specs, plan)
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], plan) for k, v in tree.items()}
    return [_place_tree(v, s, plan) for v, s in zip(tree, specs)]


def train_state_pspecs(state, cfg, plan, opt_cfg) -> dict:
    """{"params": by the port's names, "opt": `opt_pspecs` (and "ef" as the
    parameters)} for a `TrainState`'s tree, the reference's
    `shardings_of` (launch/train.py) before its NamedShardings."""
    from .dist.sharding import param_pspecs
    from .train.optimizer import opt_pspecs
    from .train.stacks import reference_leaves
    from .train.train_step import master_leaves

    pspecs = param_pspecs(state.params, plan)
    leaf_specs = reference_leaves(pspecs, cfg.period)
    ospecs = opt_pspecs(master_leaves(state.params, cfg), leaf_specs, opt_cfg)
    if "ef" in state.opt:  # the error-feedback residual shards like the parameters
        ospecs["ef"] = leaf_specs
    return {"params": pspecs, "opt": ospecs}


def distribute_train_state(state, cfg, plan, opt_cfg):
    """A whole `TrainState` that every rank holds alike, placed on the mesh
    in place: the parameters by `param_pspecs`, the moments by
    `opt_pspecs`, the compression residual like the parameters, the step
    replicated.  Returns `state`."""
    specs = train_state_pspecs(state, cfg, plan, opt_cfg)
    state.opt = _place_tree(state.opt, specs["opt"], plan)
    distribute_params(state.params, plan)
    return state


def distribute_caches(caches: list[dict], cfg, plan) -> list[dict]:
    """Decode caches (one dict per layer) that every rank holds alike,
    placed by `serve.engine.cache_pspecs`."""
    from .serve.engine import cache_pspecs

    return _place_tree(caches, cache_pspecs(cfg, plan), plan)
