"""The trees that the optimizer, gradient compression and the train step
share: flat dicts from the reference's leaf names to a tensor, or to a
*stack*, the list of tensors that the reference stacks into one leaf.

The reference stacks each layer-pattern position's parameters over the
repeats (`blocks.<pos>.<leaf>`, leading dimension n_reps) and the whisper
encoder's over its layers (`encoder.blocks.<leaf>`); the port keeps one
tensor per layer, in depth order.  A stack is that leaf held as its
layers, so every rule of the reference that reads a leaf whole keeps the
reference's meaning: its rank (one more than a layer's tensor: weight decay,
the compute-dtype cast and the factored second moment apply from rank 2),
its int8 scale (one for the stack) and its norm.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

__all__ = ["Leaf", "members", "rank", "is_layer_leaf", "map_tree", "reference_leaves"]

Leaf = Union[torch.Tensor, list]


def members(leaf: Leaf) -> list[torch.Tensor]:
    """The tensors of a leaf: a stack's layers, or the tensor alone."""
    return leaf if isinstance(leaf, list) else [leaf]


def rank(leaf: Leaf) -> int:
    """The rank the reference gives the leaf (a stack has one more)."""
    return leaf[0].dim() + 1 if isinstance(leaf, list) else leaf.dim()


def is_layer_leaf(name: str) -> bool:
    """Whether the port's tensor `name` is one layer of a stacked leaf."""
    return name.startswith(("blocks.", "encoder.blocks."))


def map_tree(fn: Callable[[torch.Tensor], torch.Tensor], tree: dict) -> dict:
    """`fn` on every tensor of a tree, stacks kept as lists."""
    return {k: [fn(t) for t in v] if isinstance(v, list) else fn(v) for k, v in tree.items()}


def reference_leaves(named: dict[str, torch.Tensor], period: int) -> dict[str, Leaf]:
    """Depth-order tensors by the port's names (`blocks.<i>.<leaf>`,
    `encoder.blocks.<i>.<leaf>`, as `named_parameters` gives them) grouped
    under the reference's leaf names: layer i is repeat i // period of
    position i % period.  The tensors are the given ones, not copies."""
    out: dict[str, Leaf] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            i = int(parts[1])
            key, rep = f"blocks.{i % period}.{'.'.join(parts[2:])}", i // period
        elif parts[:2] == ["encoder", "blocks"]:
            key, rep = f"encoder.blocks.{'.'.join(parts[3:])}", int(parts[2])
        else:
            out[name] = t
            continue
        stack = out.setdefault(key, [])
        if len(stack) != rep:
            raise ValueError(f"{name}: layers must come in depth order")
        stack.append(t)
    return out
