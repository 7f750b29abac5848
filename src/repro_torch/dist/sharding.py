"""The sharding plan: the LM stack's spec rules on a `torch.distributed`
`DeviceMesh`, the COO stream partitioner and the placement of its shards.

Counterpart of `repro.dist.sharding`.  One `ShardingPlan` serves both of
the reference's uses:

  * the LM stack's mesh (`mesh`, `dp` data axes, `tp` model axis, `fsdp`,
    `sp`): every spec rule derives from it, as in the reference —
    parameter specs (`param_pspecs` / `_leaf_spec`: column-parallel
    projections shard their output dim over ``tp``, row-parallel
    (wo/wd/out_proj) their input dim, fsdp adds the data axes), activation
    specs (`plan.hidden() / logits() / scores() / kv_cache() / ssm_state()
    / conv_state()`), batch specs (`batch_specs` / `batch_pspecs`) and
    validity (`valid_spec` strikes an axis whose size does not divide the
    dim).  A spec is a `PartitionSpec`, a tuple whose entries are None, a
    mesh axis name or a tuple of names, as JAX's; `placements` turns it
    into one DTensor placement per mesh dimension, and `shard` is the
    counterpart of `with_sharding_constraint`: a DTensor redistribute;
  * the sharded planned path (`devices`): shard d runs on `devices[d]`
    (`repro_torch.dist.planned.shard_plan`).

The parameter rules walk the port's tree, whose layers are separate
tensors where the reference stacks them: a layer's spec is the reference's
spec of its stacked leaf with the stack entry dropped (`param_pspecs`).

The stream partitioner (`StreamPartition`, `stream_imbalance`,
`partition_stream`) is host numpy with the reference's cut points and
shards to the bit.  Its split follows the paper's traffic model: each DMA
engine serves a contiguous slice of the output coordinate space, so a
shard's remapped layout (its BlockPlan) writes a disjoint set of output
tiles and the reduction of the partial factor rows across shards is a
plain sum.

Nothing here touches a process group at import; the DTensor helpers at
the end (`place`, `replicated`, `local_call`, `full`) act only on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core.coo import SparseTensor

__all__ = ["PartitionSpec", "P", "ShardingPlan", "NamedSharding", "NOPLAN", "make_plan", "valid_spec", "placements", "shard",
           "param_pspecs", "batch_specs", "batch_pspecs", "is_dtensor", "place", "place_batch", "replicated", "local_call",
           "local_offset", "full", "StreamPartition", "partition_stream", "shard_cut_points", "stream_imbalance"]


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of names (the dim split over those axes, major to minor).
    The port's stand-in for `jax.sharding.PartitionSpec`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def _axes_size(mesh, axes) -> int:
    """Product of mesh-axis sizes for a spec entry (name or tuple of names).
    Duck-typed: only `.shape[name]` is consulted (tests use fake meshes)."""
    if mesh is None or axes is None:
        return 1
    names = axes if isinstance(axes, (tuple, list)) else (axes,)
    size = 1
    for n in names:
        size *= int(_mesh_shape(mesh)[n])
    return size


def _mesh_shape(mesh) -> dict:
    """{axis name: size}: a duck-typed mesh's `.shape` dict, or a
    `DeviceMesh`'s dimension names and sizes."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return shape
    return dict(zip(mesh.mesh_dim_names, shape))


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Mesh + axis assignment.  ``dp`` is a tuple of data-parallel axis names
    (("pod", "data") on the multi-pod mesh), ``tp`` the tensor-parallel axis.
    ``fsdp`` additionally shards parameters/optimizer state over ``dp``
    (ZeRO-3 analogue); ``sp`` shards activation sequence dims over ``tp``.

    ``devices`` is the sharded planned path's placement: shard d on
    `devices[d]`.  A device may appear more than once: `(cuda:0,) * 4`
    runs four shards one after another on one card, `(cpu,) * 4` four on
    the CPU (the counterpart of XLA's forced host device count).  Built by
    `repro_torch.dist.planned.shard_plan`, which refuses an empty list."""

    mesh: Any = None
    dp: tuple[str, ...] | None = None
    tp: str | None = None
    fsdp: bool = False
    sp: bool = False
    devices: tuple[torch.device, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    # ------------------------------------------------------------ axis sizes

    def tp_size(self) -> int:
        return _axes_size(self.mesh, self.tp)

    def dp_size(self) -> int:
        """The data-parallel size: the number of shards of the sharded
        planned path, else the product of the data axes' sizes."""
        if self.devices:
            return len(self.devices)
        return _axes_size(self.mesh, self.dp)

    def data_axes(self) -> tuple[str, ...]:
        """Flattened data axes (psum axis names)."""
        if self.dp is None:
            return ()
        return tuple(self.dp) if isinstance(self.dp, (tuple, list)) else (self.dp,)

    # ------------------------------------------------- activation spec rules

    def hidden(self) -> P:
        """(B, S, D) residual-stream activations."""
        return P(self.dp, self.tp if self.sp else None, None)

    def memory(self) -> P:
        """(B, S_mem, D) encoder / image-token memory."""
        return P(self.dp, self.tp if self.sp else None, None)

    def logits(self) -> P:
        """(B, S, V): vocab over TP (the unembed is column-parallel)."""
        return P(self.dp, None, self.tp)

    def scores(self, n_heads: int) -> P:
        """(B, H, Sq, Sk) attention scores: prefer the head dim; fall back to
        the query-chunk dim when H doesn't divide the model axis (qwen2's 12
        heads, whisper's 20 on 16-way TP)."""
        if self.tp is not None and n_heads % self.tp_size() == 0:
            return P(self.dp, self.tp, None, None)
        return P(self.dp, None, self.tp, None)

    def kv_cache(self, n_kv_heads: int) -> P:
        """(B, S, KVH, hd) KV-cache layout: head-sharded when KVH divides the
        model axis, else sequence-sharded (KVH=8 cannot shard 16-way)."""
        if self.tp is not None and n_kv_heads > 0 and n_kv_heads % self.tp_size() == 0:
            return P(self.dp, None, self.tp, None)
        return P(self.dp, self.tp, None, None)

    def ssm_state(self) -> P:
        """(B, H, P, N) mamba state: heads over TP."""
        return P(self.dp, self.tp, None, None)

    def conv_state(self) -> P:
        """(B, K-1, C) conv tail: channels over TP."""
        return P(self.dp, None, self.tp)

    def stream(self) -> P:
        """Leading-dim sharding of a flat non-zero / token stream over the
        data axes (the DMA-engine partitioning of the COO stream)."""
        return P(self.dp)


NOPLAN = ShardingPlan()


def make_plan(mesh, cfg=None, *, sp: bool = False) -> ShardingPlan:
    """Build the canonical plan for a mesh: ``model`` is the TP axis, every
    other axis is data-parallel; ``fsdp`` comes from the arch config."""
    axis_names = tuple(mesh.axis_names if hasattr(mesh, "axis_names") else mesh.mesh_dim_names)
    tp = "model" if "model" in axis_names else None
    dp = tuple(n for n in axis_names if n != "model") or None
    return ShardingPlan(mesh=mesh, dp=dp, tp=tp, fsdp=bool(getattr(cfg, "fsdp", False)), sp=sp)


# ---------------------------------------------------------------------------
# spec validity, placements, constraints
# ---------------------------------------------------------------------------


def valid_spec(shape: tuple[int, ...], spec: P | None, mesh) -> P:
    """Strike every spec entry whose axis-size product does not divide the
    corresponding dim (fallback to replication on that dim).  Entry length is
    preserved; tuple entries are all-or-nothing."""
    if spec is None:
        return P(*([None] * len(shape)))
    entries = list(spec)[: len(shape)]
    out = []
    for dim, axis in zip(shape, entries):
        if axis is not None and dim % _axes_size(mesh, axis) == 0:
            out.append(axis)
        else:
            out.append(None)
    return P(*out)


def placements(spec: P, mesh) -> tuple:
    """One DTensor placement per mesh dimension: `Shard(d)` where tensor dim
    d's entry names that mesh axis, `Replicate()` otherwise.  A tuple entry
    such as ("pod", "data") shards dim d over both; DTensor splits over mesh
    dims in their order, so the mesh's order of the axes is JAX's major to
    minor.  An axis of one device splits nothing and is `Replicate()` (the
    same data; DTensor then plans no redistribution across it).  Raises
    where one axis is named twice."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    seen = set()
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if axis is None:
                continue
            if axis in seen:
                raise ValueError(f"spec {spec} names mesh axis {axis!r} twice")
            seen.add(axis)
            i = names.index(axis)
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, spec: P | None, plan: ShardingPlan = NOPLAN) -> torch.Tensor:
    """The counterpart of `with_sharding_constraint`: on a mesh, `x` (a
    DTensor) redistributed to the placements of `spec`, its entries
    divisibility-filtered first, so rules can name axes optimistically.
    The identity off a mesh or for a spec of None."""
    if plan is None or plan.mesh is None or spec is None:
        return x
    spec = valid_spec(tuple(x.shape), spec, plan.mesh)
    return x.redistribute(plan.mesh, placements(spec, plan.mesh))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

# Row-parallel projections: the TP-sharded dim is *contracted* by the matmul,
# inducing the single all-reduce per block (megatron convention).
_ROW_PARALLEL = {"wo", "wd", "out_proj"}
# Biases/vectors living in the output dim of a column-parallel projection.
_TP_VECTORS = {"bq", "bk", "bv", "bu", "conv_b"}
# 1-D-per-feature leaves that always replicate (norm scales, gates, SSM
# per-head constants): tiny, and sharding them buys nothing.
_REPLICATED = {"scale", "bias", "gate_attn", "gate_ffn", "A_log", "D", "dt_bias", "bd"}


def _leaf_spec(keys: tuple[str, ...], shape: tuple[int, ...], plan: ShardingPlan) -> P:
    """Parameter-leaf spec by name convention, the reference's rule.
    ``keys`` is the string path into the parameter tree; everything before
    the trailing matrix dims is a stack dim (layer repeats, expert stacks)
    and stays unsharded."""
    name = keys[-1] if keys else ""
    tp = plan.tp
    fs = plan.dp if plan.fsdp else None
    ndim = len(shape)
    if name in ("embed", "lm_head"):
        # vocab over TP; if the (unpadded) vocab doesn't divide, d_model
        # picks up TP instead of silently replicating the biggest table.
        if tp is not None and shape[0] % _axes_size(plan.mesh, tp) == 0:
            return P(tp, fs)
        return P(None, tp)
    if name in _REPLICATED:
        return P(*([None] * ndim))
    if ndim >= 2:
        lead = [None] * (ndim - 2)
        if name in _ROW_PARALLEL:
            return P(*lead, tp, fs)
        return P(*lead, fs, tp)  # column-parallel default (wq/wk/wv/wu/wg/...)
    if ndim == 1 and name in _TP_VECTORS:
        return P(tp)
    return P(*([None] * ndim))


def _is_layer(name: str) -> bool:
    """Whether the port's tensor `name` is one layer of a leaf the reference
    stacks over its layer repeats (`train/stacks.py`)."""
    return name.startswith(("blocks.", "encoder.blocks."))


def param_pspecs(params, plan: ShardingPlan) -> dict[str, P]:
    """{the port's parameter name: spec} for a `Params` tree (or a dict of
    named tensors, on any device, `meta` included).  A layer's spec is the
    reference's spec of the stacked leaf it belongs to with the stack entry
    dropped: where the reference names an axis on that layer dimension (a
    stacked column-parallel vector under fsdp), the port replicates over
    it.  Callers run ``valid_spec`` per leaf afterwards, as in the
    reference."""
    named = dict(params.named_parameters()) if hasattr(params, "named_parameters") else dict(params)
    out = {}
    for name, t in named.items():
        keys = tuple(name.split("."))
        if _is_layer(name):
            out[name] = P(*_leaf_spec(keys, (1,) + tuple(t.shape), plan)[1:])
        else:
            out[name] = _leaf_spec(keys, tuple(t.shape), plan)
    return out


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------


def _compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if getattr(cfg, "compute_dtype", "float32") == "bfloat16" else torch.float32


def batch_specs(cfg, shape_cfg, plan: ShardingPlan) -> dict[str, torch.Tensor]:
    """Batch stand-ins for one (arch, shape) cell, on the `meta` device
    (shapes and dtypes, no allocation).  Decode carries one new token +
    per-row cache positions; audio/vlm archs add their (stubbed) memory
    streams."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs: dict[str, torch.Tensor] = {}
    if shape_cfg.kind == "decode":
        specs["tokens"] = sds((B, 1), torch.int32)
        specs["pos"] = sds((B,), torch.int32)
    else:
        specs["tokens"] = sds((B, S), torch.int32)
        if shape_cfg.kind == "train":
            specs["labels"] = sds((B, S), torch.int32)
    cd = _compute_dtype(cfg)
    if cfg.family == "audio":
        specs["frames"] = sds((B, cfg.encoder_seq, cfg.d_model), cd)
    if cfg.family == "vlm":
        specs["images"] = sds((B, cfg.img_tokens, cfg.d_model), cd)
    return specs


def batch_pspecs(cfg, shape_cfg, plan: ShardingPlan) -> dict[str, P]:
    """PartitionSpecs matching ``batch_specs``: batch dim over the data axes,
    everything else replicated."""
    dp = plan.dp
    return {k: P(dp, *([None] * (v.dim() - 1))) for k, v in batch_specs(cfg, shape_cfg, plan).items()}


# ---------------------------------------------------------------------------
# DTensors on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where a whole tensor goes (the counterpart of
    `jax.sharding.NamedSharding`; `train/checkpoint.py` restores onto it)."""

    mesh: Any
    spec: PartitionSpec

    def plan(self) -> "ShardingPlan":
        return ShardingPlan(mesh=self.mesh)

    def device(self) -> torch.device:
        """This rank's device of the mesh."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)


def place(t: torch.Tensor, spec: P | None, plan: ShardingPlan) -> torch.Tensor:
    """A full tensor that every rank holds alike (drawn from one seed, read
    from one batch) as a DTensor with `spec`'s placements, divisibility-
    filtered: each rank keeps its own slice, nothing is communicated (a
    `meta` tensor: a new `meta` shard of the slice's shape).  The identity
    off a mesh."""
    if plan.mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    spec = valid_spec(tuple(t.shape), spec, plan.mesh)
    pl = placements(spec, plan.mesh)
    if t.device.type != "meta" or is_dtensor(t):
        return distribute_tensor(t, plan.mesh, pl, src_data_rank=None)
    # shapes only (the dry run): a new meta shard of the even split's shape
    local = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= plan.mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), plan.mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def place_batch(batch: dict, plan: ShardingPlan) -> dict:
    """A whole batch (every rank holds it) at `batch_pspecs`' placements:
    each tensor's leading dim over the data axes, the rest replicated.  As
    it is off a mesh."""
    return {k: place(v, P(plan.dp, *([None] * (v.dim() - 1))), plan) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t`, a tensor every rank holds alike (a mask, a position table), as a
    DTensor replicated over `like`'s mesh where `like` is a DTensor; else
    `t` itself."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, like.device_mesh, [Replicate()] * like.device_mesh.ndim, run_check=False)


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor on this rank: a DTensor gathered (`full_tensor`),
    a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local_call(fn: Callable, plan: ShardingPlan, args: Sequence[torch.Tensor | None],
               in_specs: Sequence[P | None], out_specs):
    """`fn` on each rank's local shards, for the ops that have no sharding
    rule (index writes, scans, sorts and scatters with index tensors of
    their own) or that run faster on local shards (the attention core).

    Each DTensor argument is redistributed to its spec's placements (an
    explicit gather where the spec replicates a sharded dim) and handed to
    `fn` as its local tensor; `fn`'s outputs (a tensor or a tuple of them)
    come back as DTensors with `out_specs`' placements, which must be valid
    for the outputs' global shapes.  An argument whole over a mesh axis
    that the outputs split takes a partial gradient there (each rank's part
    of the sum: a weight beside a batch, K/V beside query rows).  Off a
    mesh: `fn(*args)`."""
    if plan.mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = plan.mesh
    specs = (out_specs,) if out_specs is None or isinstance(out_specs, PartitionSpec) else tuple(out_specs)
    out_pls = [placements(s, mesh) for s in specs if s is not None]
    split = [any(isinstance(pl[i], Shard) for pl in out_pls) for i in range(mesh.ndim)]
    local = []
    for a, spec in zip(args, in_specs):
        if not is_dtensor(a):
            local.append(a)
            continue
        pl = placements(valid_spec(tuple(a.shape), spec, mesh), mesh)
        a = a.redistribute(mesh, pl)
        grad_pl = [Partial() if sp and isinstance(p, Replicate) else p for sp, p in zip(split, pl)]
        local.append(a.to_local(grad_placements=grad_pl))
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = []
    for o, spec in zip(outs, specs):
        if o is None or spec is None:
            wrapped.append(o)
            continue
        shape = _global_shape(tuple(o.shape), spec, mesh)
        wrapped.append(DTensor.from_local(o.contiguous(), mesh, placements(spec, mesh), run_check=False,
                                          shape=torch.Size(shape), stride=_contiguous_stride(shape)))
    return tuple(wrapped) if isinstance(out, tuple) else wrapped[0]


def local_offset(t: torch.Tensor, dim: int) -> int:
    """The first global index along `dim` of this rank's shard of the evenly
    sharded DTensor `t` (DTensor splits a dim over mesh dims in order)."""
    from torch.distributed.tensor import Shard

    mesh, size, off = t.device_mesh, t.shape[dim], 0
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            size //= mesh.size(i)
            off += mesh.get_local_rank(i) * size
    return off


def _global_shape(local: tuple[int, ...], spec: P, mesh) -> tuple[int, ...]:
    """The global shape of an evenly sharded tensor from a local shard's."""
    return tuple(n * _axes_size(mesh, e) for n, e in zip(local, list(spec) + [None] * (len(local) - len(spec))))


def _contiguous_stride(shape: tuple[int, ...]) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


@dataclasses.dataclass
class StreamPartition:
    """A COO stream split into per-shard output-mode tile ranges.

    Invariants (the reference's, tested in both packages): every non-zero
    lands in exactly one shard; the cut points are multiples of `tile` in
    the output coordinate, so no output tile is split across two shards;
    within a shard the non-zeros keep their order (`positions` increases),
    and `reassemble()` gives back the exact original stream."""

    mode: int  # the output mode the split keys on
    tile: int  # alignment (the plan's tile_i)
    shape: tuple[int, ...]
    tile_bounds: tuple[int, ...]  # nshards + 1 cut points, in tiles
    shards: list[SparseTensor]  # global shape and coordinates
    positions: list[np.ndarray]  # each shard non-zero's place in the stream

    @property
    def nshards(self) -> int:
        return len(self.shards)

    @property
    def shard_nnz(self) -> tuple[int, ...]:
        return tuple(s.nnz for s in self.shards)

    def row_ranges(self) -> tuple[tuple[int, int], ...]:
        """Each shard's [start, end) output rows (tile-aligned; the last
        clipped to the mode length)."""
        n = self.shape[self.mode]
        return tuple((min(b * self.tile, n), min(e * self.tile, n))
                     for b, e in zip(self.tile_bounds[:-1], self.tile_bounds[1:]))

    def imbalance(self) -> float:
        """max / mean shard nnz: 1.0 is a perfect balance."""
        return stream_imbalance(self.shard_nnz)

    def reassemble(self) -> SparseTensor:
        """The shards scattered back into the original stream, order
        included; raises on a non-zero dropped or duplicated."""
        total = sum(self.shard_nnz)
        idx = np.zeros((total, len(self.shape)), np.int32)
        val = np.zeros((total,), np.float32)
        seen = np.zeros((total,), bool)
        for sh, pos in zip(self.shards, self.positions):
            if np.any(seen[pos]):
                raise ValueError("duplicated non-zeros across shards")
            seen[pos] = True
            idx[pos] = sh.indices
            val[pos] = sh.values
        if not np.all(seen):
            raise ValueError("dropped non-zeros: shards do not cover the stream")
        return SparseTensor(idx, val, self.shape)


def stream_imbalance(shard_nnz) -> float:
    """max / mean of per-shard nnz (1.0 for a perfect balance and for an
    empty stream): the balance that `StreamPartition.imbalance` and
    `ShardedPMSEstimate.imbalance` report."""
    total = sum(shard_nnz)
    if total == 0:
        return 1.0
    return max(shard_nnz) / (total / len(shard_nnz))


def shard_cut_points(st: SparseTensor, mode: int, nshards: int, *,
                     tile: int = 1) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """`partition_stream`'s cut points (nshards + 1, in tiles) and each
    shard's nnz, from the per-tile histogram alone: no shard is copied."""
    if nshards < 1:
        raise ValueError(f"nshards must be >= 1, got {nshards}")
    if not 0 <= mode < st.nmodes:
        raise ValueError(f"mode {mode} out of range for a {st.nmodes}-mode tensor")
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    ntiles = max(1, -(-st.shape[mode] // tile))
    tile_of = st.indices[:, mode].astype(np.int64) // tile
    cum = np.cumsum(np.bincount(tile_of, minlength=ntiles))
    # Cut after the tile where the prefix sum first reaches each quantile;
    # searchsorted on the non-decreasing sum keeps the cuts in order.
    targets = int(st.nnz) * np.arange(1, nshards, dtype=np.float64) / nshards
    cuts = np.minimum(np.searchsorted(cum, targets, side="left") + 1, ntiles)
    bounds = np.concatenate([[0], cuts, [ntiles]]).astype(np.int64)
    cum0 = np.concatenate([[0], cum])
    return tuple(int(b) for b in bounds), tuple(int(n) for n in cum0[bounds[1:]] - cum0[bounds[:-1]])


def partition_stream(st: SparseTensor, mode: int, nshards: int, *, tile: int = 1) -> StreamPartition:
    """Split a COO stream into `nshards` contiguous output-mode tile ranges
    with balanced nnz: a greedy split of the per-tile histogram's prefix
    sum at each d / nshards quantile (`shard_cut_points`).

    Every shard keeps the global shape and coordinates, so its plan emits
    global output tile ids and the shards' partial outputs add up to the
    whole.  Cut points are multiples of `tile` (pass the plan's tile_i).
    Shards are empty where nnz or the tile count is smaller than
    `nshards`."""
    bounds, _ = shard_cut_points(st, mode, nshards, tile=tile)
    tile_of = st.indices[:, mode].astype(np.int64) // tile
    # A tile belongs to the last range starting at or before it (equal cut
    # points make empty ranges, resolved in favour of the later shard); one
    # lookup per tile, then a gather per non-zero.
    ntiles = bounds[-1]
    shard_of = (np.searchsorted(np.asarray(bounds), np.arange(ntiles), side="right") - 1)[tile_of]
    shards, positions = [], []
    for d in range(nshards):
        pos = np.flatnonzero(shard_of == d)
        positions.append(pos)
        shards.append(SparseTensor(st.indices[pos], st.values[pos], st.shape))
    return StreamPartition(mode=mode, tile=tile, shape=st.shape, tile_bounds=bounds,
                           shards=shards, positions=positions)
