"""Hypergraph model of spMTTKRP (paper Sec. 3).

Counterpart of `repro.core.hypergraph`, host numpy as there: the traffic
models and `stats` return the same numbers bit for bit.

Vertices = tensor coordinates of every mode (|V| = sum(I_m)); hyperedges =
non-zeros (|E| = nnz).  The two traversal orders (Approach 1: by output-mode
vertex; Approach 2: by input-mode vertex) give the external-traffic models of
Table 1.  This module provides those analytical traffic models plus measured
statistics used by the PMS (Sec. 5.3).
"""
from __future__ import annotations

import dataclasses

from .coo import SparseTensor

__all__ = [
    "TrafficModel",
    "approach1_traffic",
    "approach2_traffic",
    "remap_overhead",
    "HypergraphStats",
    "stats",
]


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """External-memory element counts for one mode of spMTTKRP (Table 1)."""

    tensor_loads: int  # |T| hyperedge loads
    factor_elems: int  # input/output factor-matrix elements moved
    partial_sum_elems: int  # Approach-2 partial-sum store+load traffic
    compute_ops: int  # N * |T| * R multiply-adds

    @property
    def total_elems(self) -> int:
        return self.tensor_loads + self.factor_elems + self.partial_sum_elems

    def bytes(self, elem_bytes: int = 4, tensor_elem_bytes: int = 16) -> int:
        return (
            self.tensor_loads * tensor_elem_bytes
            + (self.factor_elems + self.partial_sum_elems) * elem_bytes
        )


def approach1_traffic(st: SparseTensor, mode: int, rank: int) -> TrafficModel:
    """Output-mode-direction traversal: |T| + (N-1)*|T|*R + I_out*R, no
    partial sums (Table 1, row 1)."""
    n = st.nmodes
    t = st.nnz
    i_out = st.shape[mode]
    return TrafficModel(
        tensor_loads=t,
        factor_elems=(n - 1) * t * rank + i_out * rank,
        partial_sum_elems=0,
        compute_ops=n * t * rank,
    )


def approach2_traffic(st: SparseTensor, mode: int, rank: int, in_mode: int | None = None) -> TrafficModel:
    """Input-mode-direction traversal: |T| + N*|T|*R + I_in*R with |T|*R
    partial sums stored + re-loaded (Table 1, row 2)."""
    n = st.nmodes
    t = st.nnz
    if in_mode is None:
        in_mode = (mode + 1) % n
    i_in = st.shape[in_mode]
    return TrafficModel(
        tensor_loads=t,
        factor_elems=n * t * rank + i_in * rank,
        partial_sum_elems=t * rank,  # stored once, accumulated later
        compute_ops=n * t * rank,
    )


def remap_overhead(st: SparseTensor, mode: int, rank: int) -> float:
    """Paper Sec. 3.1: remap adds 2|T| accesses; relative overhead
    2|T| / (|T| + (N-1)|T|R + I_out R)  ~=  2 / (1 + (N-1) R).
    Returns the exact ratio for this tensor."""
    base = approach1_traffic(st, mode, rank).total_elems
    return 2.0 * st.nnz / float(base)


@dataclasses.dataclass(frozen=True)
class HypergraphStats:
    """Measured hypergraph statistics feeding the PMS locality model."""

    nnz: int
    nmodes: int
    shape: tuple[int, ...]
    degree_mean: tuple[float, ...]  # mean hyperedges per vertex, per mode
    degree_max: tuple[int, ...]
    degree_cv: tuple[float, ...]  # coefficient of variation (skew measure)
    occupied_frac: tuple[float, ...]  # fraction of coordinates with >=1 nnz


def stats(st: SparseTensor) -> HypergraphStats:
    """The tensor's hypergraph statistics, computed once per tensor object
    (its arrays are treated as immutable, as for `fingerprint`): every
    mode's search of an auto-tuned workspace reads them, and at NELL-2 size
    they take seconds on the host."""
    cached = getattr(st, "_hypergraph_stats", None)
    if cached is not None:
        return cached
    means, maxs, cvs, occ = [], [], [], []
    for m in range(st.nmodes):
        h = st.mode_histogram(m)
        nz = h[h > 0]
        means.append(float(nz.mean()) if nz.size else 0.0)
        maxs.append(int(nz.max()) if nz.size else 0)
        cvs.append(float(nz.std() / max(nz.mean(), 1e-9)) if nz.size else 0.0)
        occ.append(float(nz.size) / st.shape[m])
    st._hypergraph_stats = HypergraphStats(
        nnz=st.nnz,
        nmodes=st.nmodes,
        shape=st.shape,
        degree_mean=tuple(means),
        degree_max=tuple(maxs),
        degree_cv=tuple(cvs),
        occupied_frac=tuple(occ),
    )
    return st._hypergraph_stats
