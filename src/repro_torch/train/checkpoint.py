"""Atomic, keep-last-k checkpointing with an asynchronous write.
Counterpart of `repro.train.checkpoint`.

Layout: ``<dir>/step_<n>/``
    manifest.json        tree structure (JSON), dtypes, shapes, step
    arr_<i>.npy          one file per leaf, as a host array

  * **Atomic**: a save writes ``step_<n>.tmp`` and renames it only after
    the manifest is fsynced, so a crash mid-write never leaves a
    readable but partial checkpoint; a step directory without a manifest
    is ignored.
  * **Keep-last-k**: older steps are pruned after each save.
  * **Async**: `save(..., blocking=False)` copies the leaves to host
    memory at once (a CPU tensor or a numpy array is copied too, so a
    step that updates it in place while the thread writes does not reach
    the checkpoint) and writes them on a daemon thread (at most one
    outstanding save).
  * **Restore onto devices**: `restore(step, device=...)` returns the
    leaves as tensors on `device` (the CPU by default); `restore(step,
    shardings=...)`, the elastic restore, takes a tree of the saved tree's
    structure whose leaves are devices or `NamedSharding`s (a mesh and a
    spec) and puts each leaf on its device, or on the mesh at its spec's
    placements (each rank keeps its shards), whatever mesh or devices
    saved it (the reference's tree of shardings).

`save_train_state` / `restore_train_state` carry the LM stack's
`TrainState` (parameters, optimizer moments, step, compression residual)
through a manager.  On a mesh every rank calls them: the save gathers each
DTensor leaf whole (so the leaf files are the reference's whatever the
mesh), one leaf at a time, each copied to the host before the next is
gathered (a rank never holds more than one whole leaf on its device
beside its shards), and rank 0 writes; the restore reads the whole leaves
on every rank and copies each rank's shards into the state at its own
placements, so a checkpoint saved on one mesh restores onto another.

Leaves are torch tensors (copied to numpy), numpy arrays or
Python scalars.  The tree's structure, nested dicts (string or integer
keys), tuples and lists, goes into the manifest as JSON, not as a pickle,
so reading a checkpoint runs no code from it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..dist.sharding import NamedSharding, full, is_dtensor, place

__all__ = ["CheckpointManager", "save_train_state", "restore_train_state"]


def _flatten(tree: Any, leaves: list) -> Any:
    """The JSON structure of `tree`, appending its leaves to `leaves` in
    order (dict entries by sorted key, as the reference's pytrees)."""
    if isinstance(tree, dict):
        keys = sorted(tree, key=lambda k: (isinstance(k, str), k))
        for k in keys:
            if not isinstance(k, (str, int)) or isinstance(k, bool):
                raise TypeError(f"checkpoint dict keys must be str or int, got {k!r}")
        return {"dict": [[k, _flatten(tree[k], leaves)] for k in keys]}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [_flatten(x, leaves) for x in tree]}
    leaves.append(tree)
    return None


def _unflatten(spec: Any, leaves: list) -> Any:
    """Rebuild the tree of `spec` from the leaves (consumed in order)."""
    if spec is None:
        return leaves.pop(0)
    (kind, items), = spec.items()
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in items}
    children = [_unflatten(s, leaves) for s in items]
    if kind == "tuple":
        return tuple(children)
    if kind == "list":
        return children
    raise ValueError(f"unknown node {kind!r} in a checkpoint's tree structure")


def _host(leaf: Any) -> np.ndarray:
    """A host copy of `leaf`: never a view of its storage."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return leaf.numpy().copy() if leaf.device.type == "cpu" else leaf.cpu().numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = os.fspath(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Copy the leaves to host memory now; write them to disk now, or
        on a thread with blocking=False."""
        leaves: list = []
        structure = _flatten(tree, leaves)
        self._save_host(step, structure, [_host(x) for x in leaves], blocking)

    def _save_host(self, step: int, structure: Any, host: list[np.ndarray], blocking: bool) -> None:
        """`save` of leaves already copied to host memory (owned here)."""
        meta = {
            "step": int(step),
            "tree": structure,
            "nleaves": len(host),
            "dtypes": [str(h.dtype) for h in host],
            "shapes": [list(h.shape) for h in host],
        }
        self.wait()  # at most one outstanding save
        if blocking:
            self._write(step, host, meta)
        else:
            self._thread = threading.Thread(target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()

    def _write(self, step: int, host: list[np.ndarray], meta: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, h in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), h)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the atomic publish
        self._prune()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        """The published steps (a directory with its manifest), ascending."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device: str | torch.device | None = None,
                shardings: Any = None) -> tuple[int, Any]:
        """Load step `step` (the latest by default) with every leaf a tensor
        on `device` (the CPU unless given), or, with `shardings` (a tree of
        devices of the saved tree's structure), each leaf on its own
        device.  Raises ValueError where `shardings` has another structure
        (a misaligned tree would put leaves on the wrong devices) or is
        passed with `device`.  Returns (step, tree)."""
        if shardings is not None and device is not None:
            raise ValueError("pass device= or shardings=, not both")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        if shardings is not None:
            devs: list = []
            structure = json.loads(json.dumps(_flatten(shardings, devs)))
            if structure != meta["tree"]:
                raise ValueError(
                    f"checkpoint step {step} tree structure does not match the requested "
                    f"shardings ({meta['nleaves']} saved leaves vs {len(devs)})")
            devs = [x if isinstance(x, NamedSharding) else torch.device(x) for x in devs]
        else:
            devs = [torch.device(device) if device is not None else torch.device("cpu")] * meta["nleaves"]
        leaves = [_onto(torch.from_numpy(np.load(os.path.join(d, f"arr_{i}.npy"))), dev)
                  for i, dev in enumerate(devs)]
        return step, _unflatten(meta["tree"], leaves)


def _onto(t: torch.Tensor, where) -> torch.Tensor:
    """A whole leaf on a device, or on a mesh at a `NamedSharding`'s spec."""
    if isinstance(where, NamedSharding):
        return place(t.to(where.device()), where.spec, where.plan())
    return t.to(where)


# ---------------------------------------------------------------------------
# train states
# ---------------------------------------------------------------------------


def _host_whole(t: torch.Tensor, keep: bool) -> np.ndarray | None:
    """A host copy of the whole leaf `t` (a DTensor gathered: every rank
    takes part), bfloat16 as float32 (exact; numpy has no bfloat16); None
    where this rank does not keep it.  The gathered tensor is freed on
    return, before the caller gathers the next leaf."""
    whole = full(t.detach())
    if not keep:
        return None
    host = whole.cpu()
    return _host(host.float() if host.dtype == torch.bfloat16 else host)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _copy_into(dst, src, where: str = "") -> None:
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint{where}: keys {sorted(src)} where the state has {sorted(dst)}")
        for k in dst:
            _copy_into(dst[k], src[k], f"{where}.{k}")
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f"checkpoint{where}: {len(src)} entries where the state has {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, f"{where}.{i}")
    else:
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"checkpoint{where}: shape {tuple(src.shape)} where the state has {tuple(dst.shape)}")
        with torch.no_grad():
            if is_dtensor(dst):  # this rank's shards of the whole leaf, at dst's placements
                from torch.distributed.tensor import distribute_tensor

                local = dst.to_local()
                local.copy_(distribute_tensor(src.to(local.device, dst.dtype), dst.device_mesh, dst.placements,
                                              src_data_rank=None).to_local())
            else:
                dst.copy_(src)


def save_train_state(mgr: CheckpointManager, step: int, state, blocking: bool = True) -> None:
    """Save a `train_step.TrainState`: the master parameters by name, the
    optimizer state (m, v or factored r/c, step, and the compression
    residual "ef" where there is one) and the generator's state.  On a mesh
    every rank gathers the leaves whole, one at a time, and rank 0 keeps
    their host copies and writes them."""
    keep = True
    if any(is_dtensor(p) for p in state.params.parameters()):
        import torch.distributed as dist

        keep = dist.get_rank() == 0
    tree = {"params": {k: _host_whole(p, keep) for k, p in state.params.named_parameters()},
            "opt": _map(lambda t: _host_whole(t, keep), state.opt), "rng": _host(state.rng.get_state())}
    if keep:
        leaves: list = []
        structure = _flatten(tree, leaves)
        mgr._save_host(step, structure, leaves, blocking)


def restore_train_state(mgr: CheckpointManager, state, step: int | None = None) -> int:
    """Copy checkpoint `step` (the latest by default) into `state` in place,
    each leaf keeping its device and dtype.  Raises ValueError where the
    saved tree differs from the state's (another arch, optimizer or
    compression setting).  Returns the step."""
    step, tree = mgr.restore(step)
    _copy_into({"params": dict(state.params.named_parameters()), "opt": state.opt},
               {"params": tree["params"], "opt": tree["opt"]})
    state.rng.set_state(tree["rng"].to(torch.uint8))
    return step
