"""Exports resolved on first use (PEP 562), for packages whose eager import
would close an import cycle or load the LM stack with a decomposition."""
from __future__ import annotations

import importlib
import sys


def lazy_attrs(module: str, table: dict[str, str]):
    """A module-level `__getattr__` for `module`: `name` in `table` is
    imported from `table[name]` (a module path, relative to `module`'s
    package) when it is first read."""

    def __getattr__(name: str):
        if name in table:
            return getattr(importlib.import_module(table[name], sys.modules[module].__package__), name)
        raise AttributeError(f"module {module!r} has no attribute {name!r}")

    return __getattr__
