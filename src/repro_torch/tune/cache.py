"""Persistent autotune cache: fitted GPUSpecs and winning PMS configurations.

Counterpart of `repro.tune.cache`.  The PMS (core/pms.py) searches the
controller design space on every `auto_tune=True` call, and its `GPUSpec`
constants are data-sheet values; this module keeps the two things worth
keeping across processes:

  * one fitted `GPUSpec` per backend (`repro_torch.tune.calibrate` writes
    it; `pms.search(spec="measured")` reads it), and
  * the winning `search()` configuration per (kernel kind, tensor
    fingerprint, mode, rank payload, backend, spec) --
    `decompose(..., auto_tune="cached")` reads it, so a warm cache skips
    the search entirely.

Storage is one JSON file, `autotune_torch.json`, under
`$REPRO_TORCH_AUTOTUNE_DIR` (or `~/.cache/repro-torch-autotune/`): never
the JAX package's `autotune.json`.  Robustness contract, as the
reference's:

  * writes are atomic (same-directory temp file + `os.replace`): the file
    is always valid JSON, last writer wins per entry;
  * a truncated or corrupt file, an unknown `schema_version`, or an entry
    whose fields this code version does not know all read as a clean miss;
  * the schema version is bumped whenever the key derivation or the stored
    payloads change meaning.

Hits and misses are counted in `repro_torch.obs.metrics`
(``autotune_cache.{hits,misses,spec_hits,spec_misses}``) and traced as the
reference's are (`autotune_spec_store` and `autotune_cache_hit` events, an
`autotune_cache_search` span).
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Any

import torch

from ..core.memctrl import (
    GPUSpec,
    MemoryControllerConfig,
    config_from_dict,
    config_to_dict,
    spec_from_dict,
    spec_to_dict,
)
from ..obs import metrics as _metrics
from ..obs import trace as _trace

__all__ = [
    "SCHEMA_VERSION",
    "AutotuneCache",
    "cache_dir",
    "cache_path",
    "default_cache",
    "spec_fingerprint",
    "config_key",
    "cached_config",
    "current_backend",
]

#: Bump whenever the key derivation or stored payload semantics change: an
#: older on-disk file is then treated as empty (clean re-search), never
#: misread.
SCHEMA_VERSION = 1

_FILE_NAME = "autotune_torch.json"
_ENV_DIR = "REPRO_TORCH_AUTOTUNE_DIR"

# Serializes read-modify-write cycles *within* this process; cross-process
# safety comes from the atomic rename (last writer wins, file always valid).
_WRITE_LOCK = threading.Lock()


def cache_dir() -> Path:
    """Cache directory: `$REPRO_TORCH_AUTOTUNE_DIR`, else
    `~/.cache/repro-torch-autotune`.  Resolved at call time so tests can
    re-point it via the environment."""
    env = os.environ.get(_ENV_DIR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-torch-autotune"


def cache_path() -> Path:
    return cache_dir() / _FILE_NAME


def current_backend() -> str:
    """The backend this process tunes for: "cuda:<device name>" where torch
    sees a GPU, else "cpu".  Part of every cache key: a config tuned on one
    card must never be served on another."""
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name()}"
    return "cpu"


def spec_fingerprint(spec: GPUSpec) -> str:
    """Short content hash of a GPUSpec — ties a cached winning configuration
    to the exact spec the search ran under (a recalibration that moves the
    constants must invalidate stale winners)."""
    payload = json.dumps(spec_to_dict(spec), sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def config_key(
    kind: str,
    fingerprint: str,
    mode: int,
    rank_key: Any,
    *,
    backend: str,
    spec: GPUSpec,
    nshards: int | None = None,
) -> str:
    """The winning-config cache key.  Collision contract: any two searches
    that could return different winners must map to different keys — hence
    kernel kind, tensor content fingerprint, output mode, the kernel's rank
    payload (CP rank int / TTMc in-rank tuple / TT bond-pair tuple), the
    backend, the spec fingerprint, and the shard count (None for the
    single-device search) all appear verbatim."""
    shard = "single" if nshards is None else f"shards{int(nshards)}"
    return (
        f"v{SCHEMA_VERSION}|{kind}|{fingerprint}|mode={int(mode)}"
        f"|rank={rank_key!r}|backend={backend}|spec={spec_fingerprint(spec)}"
        f"|{shard}"
    )


class AutotuneCache:
    """One on-disk autotune cache file (see module docstring for the
    robustness contract).  All methods are safe to call with no file, a
    corrupt file, or a file written by a different schema version."""

    def __init__(self, path: str | Path | None = None):
        self._explicit_path = Path(path) if path is not None else None

    @property
    def path(self) -> Path:
        return self._explicit_path if self._explicit_path is not None else cache_path()

    # -- load / store ------------------------------------------------------

    def _empty(self) -> dict:
        return {"schema_version": SCHEMA_VERSION, "specs": {}, "configs": {}}

    def load(self) -> dict:
        """The parsed cache contents, degraded to empty on any defect:
        missing file, unreadable bytes, invalid JSON, non-dict payload, or a
        schema_version this code does not speak."""
        try:
            raw = self.path.read_text()
        except (OSError, ValueError):
            return self._empty()
        try:
            data = json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            return self._empty()
        if not isinstance(data, dict) or data.get("schema_version") != SCHEMA_VERSION:
            return self._empty()
        if not isinstance(data.get("specs"), dict) or not isinstance(
            data.get("configs"), dict
        ):
            return self._empty()
        return data

    def _write(self, data: dict) -> None:
        """Atomic replace: serialize, write to a same-directory temp file,
        fsync, rename.  A concurrent writer racing this one leaves the file
        as one writer's complete output — never a mix, never a truncation."""
        path = self.path
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = json.dumps(data, indent=1, sort_keys=True)
        fd, tmp = tempfile.mkstemp(
            prefix=path.name + ".", suffix=".tmp", dir=str(path.parent)
        )
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _update(self, mutate) -> None:
        """One read-modify-write cycle under the in-process lock."""
        with _WRITE_LOCK:
            data = self.load()
            mutate(data)
            self._write(data)

    def clear(self) -> None:
        """Drop every entry (writes an empty file atomically)."""
        self._update(lambda data: (data["specs"].clear(), data["configs"].clear()))

    # -- fitted specs ------------------------------------------------------

    def get_spec(self, backend: str) -> GPUSpec | None:
        """The fitted GPUSpec for `backend`, or None (miss on absence or on
        any entry this schema cannot rebuild)."""
        entry = self.load()["specs"].get(backend)
        if not isinstance(entry, dict):
            self._count("spec_misses", backend=backend)
            return None
        try:
            spec = spec_from_dict(entry.get("spec", {}))
        except (ValueError, TypeError):
            self._count("spec_misses", backend=backend)
            return None
        self._count("spec_hits", backend=backend)
        return spec

    def put_spec(self, backend: str, spec: GPUSpec, **meta) -> None:
        def mutate(data):
            data["specs"][backend] = {"spec": spec_to_dict(spec), "meta": meta}

        self._update(mutate)
        _trace.event("autotune_spec_store", backend=backend)

    # -- winning configurations -------------------------------------------

    def get_config(self, key: str) -> MemoryControllerConfig | None:
        entry = self.load()["configs"].get(key)
        if not isinstance(entry, dict):
            return None
        try:
            return config_from_dict(entry.get("cfg", {}))
        except (ValueError, TypeError):
            return None

    def put_config(self, key: str, cfg: MemoryControllerConfig, **meta) -> None:
        def mutate(data):
            data["configs"][key] = {"cfg": config_to_dict(cfg), "meta": meta}

        self._update(mutate)

    # -- accounting --------------------------------------------------------

    @staticmethod
    def _count(name: str, **labels) -> None:
        _metrics.counter(f"autotune_cache.{name}", **labels).inc()

    def stats(self) -> dict:
        data = self.load()
        return {
            "path": str(self.path),
            "schema_version": data["schema_version"],
            "specs": sorted(data["specs"]),
            "n_configs": len(data["configs"]),
        }


def default_cache() -> AutotuneCache:
    """The process-default cache (path resolved from the environment on
    every access, so re-pointing `REPRO_TORCH_AUTOTUNE_DIR` takes effect
    immediately)."""
    return AutotuneCache()


def cached_config(
    kind: str,
    fingerprint: str,
    mode: int,
    rank_key: Any,
    spec: GPUSpec,
    search_thunk,
    *,
    cache: AutotuneCache | None = None,
    nshards: int | None = None,
) -> MemoryControllerConfig:
    """The `auto_tune="cached"` lookup each `make_planned_*` makes: return the
    persisted winning configuration for this key, or run `search_thunk` (the
    full PMS sweep), persist its winner, and return it.  A hit skips the
    config sweep entirely — counted in ``autotune_cache.hits`` with zero
    ``pms.configs_evaluated`` increments; a miss counts one
    ``autotune_cache.misses`` and writes back.  `nshards`: the sharded
    path's shard count, part of the key (None for one device)."""
    cache = cache if cache is not None else default_cache()
    backend = current_backend()
    key = config_key(kind, fingerprint, mode, rank_key, backend=backend, spec=spec,
                     nshards=nshards)
    cfg = cache.get_config(key)
    if cfg is not None:
        AutotuneCache._count("hits", kind=kind)
        _trace.event("autotune_cache_hit", kind=kind, mode=int(mode))
        return cfg
    AutotuneCache._count("misses", kind=kind)
    with _trace.span("autotune_cache_search", kind=kind, mode=int(mode)):
        cfg = search_thunk()
    cache.put_config(key, cfg, backend=backend, kind=kind, mode=int(mode))
    return cfg
