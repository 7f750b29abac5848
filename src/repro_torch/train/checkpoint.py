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
    memory at once and writes them on a daemon thread (at most one
    outstanding save).
  * **Restore onto devices**: `restore(step, device=...)` returns the
    leaves as tensors on `device` (the CPU by default); `restore(step,
    shardings=...)`, the elastic restore, takes a tree of devices of the
    saved tree's structure and puts each leaf on its device, whatever
    devices saved it (the reference's tree of shardings).

Leaves are torch tensors (`.detach().cpu().numpy()`), numpy arrays or
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

__all__ = ["CheckpointManager"]


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
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


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
        host = [_host(x) for x in leaves]
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
            devs = [torch.device(x) for x in devs]
        else:
            devs = [torch.device(device) if device is not None else torch.device("cpu")] * meta["nleaves"]
        leaves = [torch.from_numpy(np.load(os.path.join(d, f"arr_{i}.npy"))).to(dev)
                  for i, dev in enumerate(devs)]
        return step, _unflatten(meta["tree"], leaves)
