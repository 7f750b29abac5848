"""The sharded planned path's one collective per mode, single-process.

The reference runs its shards under `shard_map` and joins their partial
outputs with one `psum` per mode.  Here one process drives every shard:
`reduce_partials` brings each shard's partial output to the first shard's
device and adds them in shard order (a fixed order, so a run repeats to
the bit), and `Replicas` keeps the padded factors on every other device a
shard runs on, refreshed after each mode's update.  On one card, or with
every shard on one device, both are no-ops apart from the adds.  A
multi-process all-reduce (NCCL) would replace these two and nothing else.
Copies and adds here are library calls: this is a collective, not a
kernel.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import torch

__all__ = ["Replicas", "reduce_partials"]


def reduce_partials(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the shards' partial outputs, on the first one's device,
    added in shard order.  The shards own disjoint output tiles and each
    kernel writes exact zeros elsewhere, so the sum joins them without
    rounding."""
    total = parts[0]
    if len(parts) == 1:
        return total
    home = total.device
    total = total + parts[1].to(home)
    for p in parts[2:]:
        total.add_(p.to(home))
    return total


class Replicas:
    """The padded factors on every device the shards use: the sequence
    given, by mode, on its own device (the home device, where the factors
    are updated), and a copy on each other device, taken when the replicas
    are made (None stays None: a mode whose factor no shard reads).
    `refresh(m)` copies factor m from home to every other device; call it
    after factor m is written in place, never before."""

    def __init__(self, facs: Sequence[torch.Tensor | None], devices: Iterable[torch.device]):
        self.home = next(f.device for f in facs if f is not None)
        self._on = {self.home: facs}
        for dev in devices:
            if dev not in self._on:
                self._on[dev] = [None if f is None else f.to(dev) for f in facs]

    def on(self, device: torch.device) -> Sequence[torch.Tensor]:
        return self._on[device]

    def refresh(self, mode: int) -> None:
        src = self._on[self.home][mode]
        for dev, facs in self._on.items():
            if dev != self.home:
                facs[mode].copy_(src)
