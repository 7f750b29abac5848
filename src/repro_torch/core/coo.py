"""COO sparse-tensor container + synthetic FROSTT-like generators.

Counterpart of `repro.core.coo`.  The container stays host-side numpy and
the generators make the same numpy generator calls as the reference, so a
seed gives the same tensor bit for bit.  `to_device` moves the stream to a
torch device for the fit's inner product.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "SparseTensor",
    "synthetic_tensor",
    "frostt_like",
    "norm_sq",
    "to_device",
]


@dataclasses.dataclass
class SparseTensor:
    """Host-side COO tensor.  `indices[z, m]` is the mode-m coordinate of nnz z."""

    indices: np.ndarray  # (nnz, nmodes) int32
    values: np.ndarray  # (nnz,) float32
    shape: tuple[int, ...]

    def __post_init__(self):
        if self.indices.ndim != 2 or self.indices.shape[1] != len(self.shape):
            raise ValueError(
                f"indices of shape {self.indices.shape} do not match a "
                f"{len(self.shape)}-mode tensor"
            )
        if self.values.shape != (self.indices.shape[0],):
            raise ValueError(
                f"values of shape {self.values.shape} do not match "
                f"{self.indices.shape[0]} non-zeros"
            )
        self.indices = np.asarray(self.indices, np.int32)
        self.values = np.asarray(self.values, np.float32)
        self.shape = tuple(int(s) for s in self.shape)

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def density(self) -> float:
        return self.nnz / float(np.prod([float(s) for s in self.shape]))

    def nbytes(self, index_bytes: int = 4, value_bytes: int = 4) -> int:
        """Size of the COO stream, |T| elements (the paper's tensor-size metric)."""
        return self.nnz * (self.nmodes * index_bytes + value_bytes)

    def mode_histogram(self, mode: int) -> np.ndarray:
        """Non-zeros per coordinate of `mode` (hypergraph vertex degrees)."""
        return np.bincount(self.indices[:, mode], minlength=self.shape[mode])

    def sorted_by(self, mode: int) -> "SparseTensor":
        """Stable sort by one mode's coordinates (the host-side remap)."""
        order = np.argsort(self.indices[:, mode], kind="stable")
        return SparseTensor(self.indices[order], self.values[order], self.shape)

    def is_sorted_by(self, mode: int) -> bool:
        c = self.indices[:, mode]
        return bool(np.all(c[1:] >= c[:-1]))

    def fingerprint(self) -> str:
        """Content hash of (shape, indices, values): the same hex string as
        the reference's for the same arrays, so the autotune cache keys of
        both packages name a tensor alike.  Cached on the instance; the
        arrays are treated as immutable after construction."""
        fp = getattr(self, "_fingerprint", None)
        if fp is None:
            h = hashlib.sha1()
            h.update(repr(self.shape).encode())
            h.update(np.ascontiguousarray(self.indices).tobytes())
            h.update(np.ascontiguousarray(self.values).tobytes())
            fp = h.hexdigest()
            self._fingerprint = fp
        return fp


def norm_sq(st: SparseTensor) -> float:
    """||X||_F^2 summed in float64 on the host (the reference's rule)."""
    return float(np.sum(st.values.astype(np.float64) ** 2))


def to_device(st: SparseTensor, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The COO stream on `device`: (nnz, nmodes) int32 indices, (nnz,) f32 values."""
    return (
        torch.from_numpy(st.indices).to(device),
        torch.from_numpy(st.values).to(device),
    )


def _zipf_coords(rng: np.random.Generator, n: int, size: int, alpha: float) -> np.ndarray:
    """Skewed coordinates (power-law mode degrees, as in real FROSTT
    tensors).  alpha=0 -> uniform.  Same generator calls as the reference."""
    if alpha <= 0:
        return rng.integers(0, size, n, dtype=np.int64)
    ranks = np.arange(1, size + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    coords = rng.choice(size, size=n, p=probs)
    perm = rng.permutation(size)
    return perm[coords]


def synthetic_tensor(
    shape: Sequence[int],
    nnz: int,
    *,
    seed: int = 0,
    skew: float = 0.0,
    dedup: bool = False,
) -> SparseTensor:
    """Random sparse tensor with optional per-mode zipf skew."""
    rng = np.random.default_rng(seed)
    cols = [_zipf_coords(rng, nnz, s, skew) for s in shape]
    idx = np.stack(cols, axis=1).astype(np.int32)
    if dedup:
        idx = np.unique(idx, axis=0)
    vals = rng.standard_normal(idx.shape[0]).astype(np.float32)
    return SparseTensor(idx, vals, tuple(int(s) for s in shape))


# name: (shape, nnz, skew) — the reference's presets.
FROSTT_PRESETS = {
    "tiny": ((64, 48, 80), 2_000, 0.8),
    "small": ((1_000, 800, 1_200), 50_000, 0.9),
    "medium": ((20_000, 15_000, 25_000), 500_000, 1.0),
    "large": ((200_000, 150_000, 250_000), 4_000_000, 1.0),
    "nell2_like": ((12_092, 9_184, 28_818), 2_000_000, 1.1),
    "4d_small": ((500, 400, 600, 300), 40_000, 0.8),
    "5d_small": ((120, 100, 150, 80, 60), 20_000, 0.6),
}


def frostt_like(name: str = "small", seed: int = 0) -> SparseTensor:
    """Synthetic stand-ins shaped like FROSTT-repository tensors."""
    shape, nnz, skew = FROSTT_PRESETS[name]
    return synthetic_tensor(shape, nnz, seed=seed, skew=skew)
