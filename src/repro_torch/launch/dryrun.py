"""Multi-pod dry run: the port of `repro.launch.dryrun`.  Proves, without
hardware, that every (arch x shape x mesh) cell builds on its production
mesh, places every input by the spec rules and fits per-device memory.

Per cell this module:
  1. begins a "fake" `torch.distributed` process group of 256 ranks (the
     single-pod 16 x 16 mesh) or 512 (the multi-pod 2 x 16 x 16 mesh)
     where no group is running (`fake_process_group`; it is destroyed
     before the cell returns), and builds `launch/mesh.make_production_mesh`
     on it, of device type "cuda" (`MESH_DEVICE_TYPE`: NCCL's collectives,
     all-to-all among them; torch 2.11 and 2.13 run `meta` DTensors on such
     a mesh with no card);
  2. builds the cell's inputs on the `meta` device (shapes and dtypes, no
     allocation) and places them as DTensors by the spec rules
     (`param_pspecs`, `opt_pspecs`, `cache_pspecs`, `batch_pspecs`, each
     divisibility-filtered by `valid_spec`): the train state, or the
     bfloat16 serving parameters, their caches and the batch;
  3. runs the cell's step (`make_train_step`, `T.prefill`,
     `T.decode_step`) once, as rank 0, under `StepCounters`: the live
     bytes of every storage (the arguments' local shards and everything
     the step allocates, freed as it dies), every collective the step
     issues, the FLOPs and the bytes its local ops read and write.

Nothing is allocated on any device, so no card is needed: this is the one
entry point `device.resolve_device` does not govern.  What differs from the
reference's XLA dry run:
  * no lowering or compiling: `trace_s` is the time of the one abstract
    step (the reference's `lower_s` / `compile_s` have no counterpart);
  * memory is a live-bytes tracker's reading of the step as it runs, not
    XLA's buffer assignment (`run_cell` defines each field);
  * collectives are counted per launch as the step issues them on rank 0
    (`collective_kind` names them as the reference does); the port unrolls
    its layers, so nothing sits in a while body counted once, and the
    full-depth counts are exact (`--probe` keeps the depth-1 / depth-2
    records for the roofline);
  * an op whose output size depends on its data (a boolean-mask index is a
    `nonzero`) cannot run on `meta`; the step runs with
    `torch.fx.experimental._config.meta_nonzero_assume_all_nonzero` set
    (only while it runs), which takes every element as selected: the
    embedding's gradient scratch (`transformer._ShardedEmbed`, each rank's
    vocabulary slice) and a sequence-sharded KV cache's decode write are
    counted as if every id or row were this rank's, an upper bound.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod] [--probe] [--out artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --matrix [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["FULL_ATTENTION", "skip_reason", "default_microbatches", "auto_remat_group", "get_n_reps",
           "collective_kind", "StepCounters", "fake_process_group", "abstract_train_state", "abstract_batch",
           "build_cell", "trace_cell", "run_cell", "main"]

#: The production mesh's device type: the collectives are those DTensor
#: issues on NCCL (a gloo "cpu" mesh gathers where NCCL sends all-to-all).
MESH_DEVICE_TYPE = "cuda"

# ---------------------------------------------------------------------------
# cell policy (the reference's, as it is)
# ---------------------------------------------------------------------------

FULL_ATTENTION = {
    "qwen3-0.6b", "qwen2-1.5b", "minitron-4b", "phi4-mini-3.8b",
    "phi3.5-moe-42b-a6.6b", "grok-1-314b", "whisper-large-v3",
    "llama-3.2-vision-11b",
}


def skip_reason(arch: str, shape: str) -> str | None:
    if shape == "long_500k" and arch in FULL_ATTENTION:
        return "long_500k needs sub-quadratic attention; skipped for pure full-attention archs (DESIGN.md §5)"
    return None


def default_microbatches(cfg, shape_cfg, mesh) -> int:
    """Gradient-accumulation depth: keep one-ish sequence per DP group per
    microbatch for wide models (activation-memory lever)."""
    if shape_cfg.kind != "train":
        return 1
    from .mesh import dp_size

    per_dp = max(1, shape_cfg.global_batch // dp_size(mesh))
    target = 1 if cfg.d_model >= 3072 else 4
    return max(1, per_dp // target)


def auto_remat_group(n_reps: int) -> int:
    """Largest divisor of n_reps <= sqrt(n_reps) (sqrt-remat schedule)."""
    if n_reps < 16:
        return 0
    best = 0
    d = 1
    while d * d <= n_reps:
        if n_reps % d == 0:
            best = d
        d += 1
    return best if best > 1 else 0


def get_n_reps(arch: str) -> int:
    from ..configs import get_config

    cfg = get_config(arch)
    return cfg.n_layers // cfg.period


# ---------------------------------------------------------------------------
# the step's counters
# ---------------------------------------------------------------------------

# The reference's kinds (XLA's op names) by the c10d / functional-collective
# op names a step can issue; DTensor's NCCL all-to-all is its own op.
_KINDS = {
    "all-gather": ("all_gather_into_tensor", "all_gather_into_tensor_coalesced", "allgather_", "_allgather_base_",
                   "allgather_coalesced_", "allgather_into_tensor_coalesced_"),
    "all-reduce": ("all_reduce", "all_reduce_coalesced", "allreduce_", "allreduce_coalesced_"),
    "reduce-scatter": ("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced", "reduce_scatter_",
                       "_reduce_scatter_base_", "reduce_scatter_tensor_coalesced_"),
    "all-to-all": ("all_to_all_single", "shard_dim_alltoall", "alltoall_", "alltoall_base_"),
    "collective-permute": ("send", "recv_", "recv_any_source_"),
    "broadcast": ("broadcast", "broadcast_"),
}
_KIND_OF = {name: kind for kind, names in _KINDS.items() for name in names}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd", "c10d", "_dtensor")
# Ops that evaluate a transcendental function once per output element.
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "erf", "rsqrt", "sqrt", "sin",
                   "cos", "pow", "silu", "gelu", "softplus", "logaddexp", "_softmax", "_log_softmax", "logsumexp"}


def collective_kind(op) -> str | None:
    """The reference's kind ("all-gather", "all-reduce", "reduce-scatter",
    "all-to-all", "collective-permute"; a broadcast as "broadcast") of a
    collective op (an `OpOverload`, an `OpOverloadPacket` or its printed
    name such as "c10d_functional.all_reduce"), or None for any other op."""
    name = getattr(op, "_overloadpacket", op)
    name = getattr(name, "_qualified_op_name", str(name)).replace("::", ".")
    namespace, _, rest = name.partition(".")
    if namespace not in _COLLECTIVE_NAMESPACES:
        return None
    return _KIND_OF.get(rest.split(".")[0])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounters(TorchDispatchMode):
    """Counts what one process's local ops do while it is entered.

      * Live bytes: every storage an op creates is counted (its `nbytes`,
        by device type) until it is freed; storages handed to `track`
        (the arguments) count from then on.  `peak_bytes` is the largest
        total, summed over the devices seen; `device_peak` the largest per
        device.
      * Collectives: per kind (`collective_kind`), the launches and the
        bytes of their outputs.
      * `flops`: the FLOPs of the matrix products, convolutions and
        attention (torch.utils.flop_counter's formulas, its
        `flop_registry`), not of elementwise work; `transcendentals`: the
        output elements of exp, log, tanh, sigmoid, softmax and the like;
        `bytes_accessed`: every op's tensor inputs and outputs, views left
        out.

    DTensor ops pass through to DTensor (which runs them as local ops, seen
    here); ops run under a fake mode (DTensor's sharding propagation) are
    not counted."""

    def __init__(self):
        super().__init__()
        self.live: dict[str, int] = {}
        self.device_peak: dict[str, int] = {}
        self.total = self.peak_bytes = 0
        self.collectives: dict[str, dict] = {}
        self.flops = 0
        self.transcendentals = 0
        self.bytes_accessed = 0
        self._refs: dict[int, weakref.ref] = {}

    def track(self, tensors) -> None:
        """Count the storages of `tensors` (a tree; DTensors by their local
        shards) as live from now on."""
        for t in tree_leaves(tensors):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def storage_keys(self, tensors) -> dict[int, int]:
        """{storage key: nbytes} of the tensors of a tree (local shards)."""
        out = {}
        for t in tree_leaves(tensors):
            if isinstance(t, torch.Tensor):
                st = _local(t).untyped_storage()
                out[st._cdata] = st.nbytes()
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n, dev = st.nbytes(), st.device.type

        def freed(_, key=key, n=n, dev=dev):
            self._refs.pop(key, None)
            self.live[dev] -= n
            self.total -= n

        self._refs[key] = weakref.ref(st, freed)
        self.live[dev] = self.live.get(dev, 0) + n
        self.total += n
        self.device_peak[dev] = max(self.device_peak.get(dev, 0), self.live[dev])
        self.peak_bytes = max(self.peak_bytes, self.total)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not None:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        kind = collective_kind(func)
        if kind is not None:
            rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += sum(_nbytes(t) for t in outs)
        packet = func._overloadpacket
        if packet in _flop_registry():
            self.flops += int(_flop_registry()[packet](*args, **kwargs, out_val=out))
        if packet.__name__ in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if not func.is_view:
            self.bytes_accessed += sum(_nbytes(t) for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor))
            self.bytes_accessed += sum(_nbytes(t) for t in outs)
        return out


def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry

    return flop_registry


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


@contextlib.contextmanager
def fake_process_group(world: int):
    """A "fake" process group of `world` ranks (this process is rank 0; the
    collectives return without communicating), begun only where no group
    is running and destroyed on exit; where one runs, it is used as it is."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _meta_nonzero():
    """A `nonzero` on `meta` takes every element as selected (an upper
    bound on the sizes that follow), while the step runs."""
    import torch.fx.experimental._config as fx_config

    old = fx_config.meta_nonzero_assume_all_nonzero
    fx_config.meta_nonzero_assume_all_nonzero = True
    try:
        yield
    finally:
        fx_config.meta_nonzero_assume_all_nonzero = old


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def abstract_train_state(cfg, opt_cfg, plan, *, compress_grads: bool = False):
    """A `TrainState` of `meta` tensors placed on the plan's mesh: the
    parameters, the zeroed moments (and the int8 residual "ef" with
    compress_grads, the steady-state step's live input), placed by
    `convert.distribute_train_state`; no generator (`rng` None)."""
    from ..convert import distribute_train_state
    from ..models import transformer as T
    from ..train.optimizer import adamw_init
    from ..train.train_step import TrainState, master_leaves

    params = T.abstract_params(cfg)
    leaves = master_leaves(params, cfg)
    opt = adamw_init(leaves, opt_cfg)
    if compress_grads:
        from ..dist.compression import init_error_feedback

        opt = init_error_feedback(opt, leaves)
    return distribute_train_state(TrainState(params=params, opt=opt, rng=None), cfg, plan, opt_cfg)


def abstract_batch(cfg, shape_cfg, plan) -> dict:
    """The cell's batch (`batch_specs`) on `meta`, placed by
    `batch_pspecs`: the batch dim over the data axes."""
    from ..dist.sharding import batch_pspecs, batch_specs, place

    specs = batch_pspecs(cfg, shape_cfg, plan)
    return {k: place(v, specs[k], plan) for k, v in batch_specs(cfg, shape_cfg, plan).items()}


def build_cell(arch, shape_name, mesh, *, num_microbatches=None, sp=False, compress_grads=False, attn_chunk=2048,
               probe_depth=None, remat=None, remat_group=None, barrier_xs=None, cache_len=None):
    """Returns (fn, args, info) for one cell: `fn(*args)` runs its step
    once on `meta` DTensors placed on `mesh` (a `DeviceMesh` over a running
    process group).  `arch` is a config name or a `ModelConfig`,
    `shape_name` a `SHAPES` key or a `ShapeConfig`; `cache_len` (prefill
    only) defaults to the shape's sequence length, as the reference's.
    info: {"cfg", "num_microbatches" (train), "kind"}."""
    from ..configs import SHAPES, get_config
    from ..convert import distribute_caches, distribute_params
    from ..dist.sharding import _mesh_shape, make_plan
    from ..models import transformer as T
    from ..serve.engine import cache_specs
    from ..train.optimizer import AdamWConfig
    from ..train.train_step import make_train_step

    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape_cfg = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if shape_cfg.kind != "train":
        # serving uses bf16 checkpoints: halves parameter args + per-layer
        # weight traffic (fp32 master is a training-only concern)
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if probe_depth is not None:  # unrolled shallow probe for exact costs
        changes = dict(n_layers=probe_depth * cfg.period, scan_unroll=True)
        if cfg.encoder_layers:
            changes["encoder_layers"] = probe_depth
        cfg = dataclasses.replace(cfg, **changes)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if probe_depth is None:
        rg = remat_group if remat_group is not None else auto_remat_group(cfg.n_layers // cfg.period)
        cfg = dataclasses.replace(cfg, remat_group=rg)
    if barrier_xs is not None:
        cfg = dataclasses.replace(cfg, barrier_xs=barrier_xs)
    plan = make_plan(mesh, cfg, sp=sp)
    if (shape_cfg.kind == "prefill" and cfg.n_heads
            and cfg.n_heads % _mesh_shape(mesh)["model"] != 0):
        # heads can't shard over TP -> scores are batch-sharded only; cap the
        # query chunk so the per-chunk f32 score buffer stays ~2 GiB
        attn_chunk = min(attn_chunk, 1024)
    opt_cfg = AdamWConfig(
        state_dtype="bfloat16" if cfg.fsdp else "float32",
        update_slices=int(os.environ.get("REPRO_UPDATE_SLICES", "1")),
        factored_v=cfg.fsdp,  # Adafactor-style v for the HBM-bound archs
    )
    batch = abstract_batch(cfg, shape_cfg, plan)
    info = dict(cfg=cfg, kind=shape_cfg.kind)

    if shape_cfg.kind == "train":
        nmb = num_microbatches or default_microbatches(cfg, shape_cfg, mesh)
        state = abstract_train_state(cfg, opt_cfg, plan, compress_grads=compress_grads)
        step_fn = make_train_step(cfg, opt_cfg, plan, num_microbatches=nmb, attn_chunk=attn_chunk,
                                  compress_grads=compress_grads)
        return step_fn, (state, batch), dict(info, num_microbatches=nmb)

    params = distribute_params(T.abstract_params(cfg), plan)
    if shape_cfg.kind == "prefill":
        cache_len = cache_len or shape_cfg.seq_len

        def prefill_fn(params, batch):
            return T.prefill(params, batch, cfg, cache_len=cache_len, plan=plan, attn_chunk=attn_chunk)

        return prefill_fn, (params, batch), info

    # decode: one new token against a seq_len cache
    caches = distribute_caches(cache_specs(cfg, shape_cfg.global_batch, shape_cfg.seq_len), cfg, plan)
    tokens, pos = batch.pop("tokens"), batch.pop("pos")  # P(dp, None) and P(dp), as the reference's
    memory = {k: v for k, v in batch.items() if k in ("frames", "images")}

    def decode_fn(params, tokens, pos, caches, memory):
        return T.decode_step(params, tokens, pos, caches, memory, cfg, plan)

    return decode_fn, (params, tokens, pos, caches, memory), info


def _state_tensors(args) -> list:
    """The tensors of a cell's arguments (a `TrainState`'s parameters and
    optimizer state; dicts, lists and tuples of tensors)."""
    from ..train.train_step import TrainState

    out = []
    for a in args:
        if isinstance(a, TrainState):
            out += list(a.params.parameters()) + tree_leaves(a.opt)
        elif hasattr(a, "parameters"):
            out += list(a.parameters())
        else:
            out += [t for t in tree_leaves(a) if isinstance(t, torch.Tensor)]
    return out


def trace_cell(fn, args) -> dict:
    """Run `fn(*args)` once under `StepCounters` (and the `nonzero` upper
    bound): {"trace_s", "memory", "cost", "transcendentals", "collectives",
    "device_bytes", "argument_storages" (each argument storage's bytes)}.
    The memory fields are rank 0's, as `run_cell` defines them."""
    counters = StepCounters()
    arg_tensors = _state_tensors(args)
    counters.track(arg_tensors)
    arg_keys = counters.storage_keys(arg_tensors)
    del arg_tensors  # what the step drops from `args` (a replaced cache) is freed as in a run
    t0 = time.perf_counter()
    with _meta_nonzero(), counters:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    out_keys = counters.storage_keys(_state_tensors(out if isinstance(out, tuple) else (out,)))
    argument_bytes = sum(arg_keys.values())
    del out
    return dict(
        trace_s=trace_s,
        memory=dict(
            argument_bytes=argument_bytes,
            output_bytes=sum(out_keys.values()),
            temp_bytes=counters.peak_bytes - argument_bytes,
            alias_bytes=sum(n for k, n in out_keys.items() if k in arg_keys),
            peak_bytes=counters.peak_bytes,
        ),
        cost=dict(flops=float(counters.flops), bytes_accessed=float(counters.bytes_accessed)),
        transcendentals=float(counters.transcendentals),
        collectives=counters.collectives,
        device_bytes=dict(counters.device_peak),
        argument_storages=list(arg_keys.values()),
    )


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, probe: bool = False,
             out_dir: str = "artifacts/dryrun", **overrides) -> dict:
    """Dry-run one cell on its production mesh (`MESH_SHAPES`: 256 or 512
    ranks of a fake process group) and write its record to
    `<out_dir>/<arch>__<shape>__<mesh>.json` (the reference's keys, and
    `trace_s`, `mesh_device_type`, `device_bytes`).  Memory, rank 0's:

      * argument_bytes: the local shards of every input (the train state,
        or the parameters, the caches and the batch);
      * output_bytes: the local shards of every output (the train state
        and the metrics; the logits and the caches);
      * alias_bytes: the outputs that are argument storages, updated in
        place (the train state; the KV caches);
      * peak_bytes: the live-bytes tracker's peak, summed over every device
        it saw (a tensor landing off `meta` is still counted; its devices
        are under `device_bytes`);
      * temp_bytes: peak_bytes - argument_bytes.

    cost: `flops` (matrix products and attention only, unlike XLA's count,
    which adds elementwise work) and `bytes_accessed` (every local op's
    tensor inputs and outputs) on rank 0.  `collectives`: per kind, the
    launches and their output bytes."""
    import math

    from . import mesh as mesh_mod

    mesh_name = "multi" if multi_pod else "single"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "nchips": math.prod(mesh_mod.MESH_SHAPES[mesh_name][0])}
    reason = skip_reason(arch, shape_name)
    if reason:
        rec["skipped"] = reason
        return rec

    with fake_process_group(rec["nchips"]):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device_type=MESH_DEVICE_TYPE)
        fn, args, info = build_cell(arch, shape_name, mesh, **overrides)
        traced = trace_cell(fn, args)
        del fn, args
        rec.update(
            ok=True,
            trace_s=round(traced["trace_s"], 1),
            mesh_device_type=MESH_DEVICE_TYPE,
            num_microbatches=info.get("num_microbatches"),
            memory=traced["memory"],
            cost=traced["cost"],
            collectives=traced["collectives"],
            device_bytes=traced["device_bytes"],
        )
        if probe:  # per-depth costs: depth-1 / depth-2 periods
            rec["probes"] = {}
            for depth in (1, 2):
                pfn, pargs, _ = build_cell(arch, shape_name, mesh, probe_depth=depth,
                                           **{**overrides, "num_microbatches": 1})
                p = trace_cell(pfn, pargs)
                rec["probes"][f"depth{depth}"] = dict(
                    flops=p["cost"]["flops"], bytes_accessed=p["cost"]["bytes_accessed"],
                    transcendentals=p["transcendentals"], collectives=p["collectives"])
                del pfn, pargs
            rec["probe_meta"] = {"period": info["cfg"].period, "n_reps_full": get_n_reps(arch)}

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    rec["artifact"] = path
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--probe", action="store_true", help="also trace depth-1 / depth-2 cost probes")
    ap.add_argument("--matrix", action="store_true", help="run every (arch x shape)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--sp", action="store_true", help="sequence-parallel activations")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--attn-chunk", type=int, default=2048)
    ap.add_argument("--remat-group", type=int, default=None)
    ap.add_argument("--barrier-xs", action="store_true", default=None)
    args = ap.parse_args(argv)

    from ..configs import SHAPES, list_configs

    cells = (
        [(a, s) for a in list_configs() for s in SHAPES]
        if args.matrix
        else [(args.arch, args.shape)]
    )
    failures = 0
    for arch, shape in cells:
        try:
            rec = run_cell(
                arch, shape, multi_pod=args.multi_pod, probe=args.probe,
                out_dir=args.out, num_microbatches=args.microbatches,
                sp=args.sp, compress_grads=args.compress_grads,
                attn_chunk=args.attn_chunk, remat_group=args.remat_group,
                barrier_xs=args.barrier_xs,
            )
            if rec.get("skipped"):
                print(f"[dryrun] SKIP {arch} {shape}: {rec['skipped']}")
            else:
                m = rec["memory"]
                print(
                    f"[dryrun] OK {arch} {shape} {rec['mesh']}: "
                    f"peak/device={m['peak_bytes']/2**30:.2f} GiB "
                    f"args={m['argument_bytes']/2**30:.2f} temp={m['temp_bytes']/2**30:.2f} "
                    f"trace={rec['trace_s']}s colls={sum(c['count'] for c in rec['collectives'].values())}",
                    flush=True,
                )
        except Exception as e:  # a failing cell is a bug: surface and count
            failures += 1
            print(f"[dryrun] FAIL {arch} {shape}: {type(e).__name__}: {e}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
