"""Sparse tensor-train decomposition (TT-ALS) on the planned TT-core kernel.

Counterpart of `repro.tt.als` for its planned path (`method="pallas"`) and
its reference method.  TT represents X by N cores G_k (rl_k, I_k, rr_k) with
boundary bonds rl_0 = rr_{N-1} = 1, and ALS updates one core at a time,
left to right:

    repeat:
      for each mode m:
        B_m[i, :] = sum_{z: i_m(z)=i} v_z * kron(l_z, r_z)   # the kernel
        A_m       = kron(P_{m-1}, Q_{m+1})                   # interface Grams
        W_m       = solve(A_m, B_m^T)^T                      # normal equations
        G_m       = fold(W_m)
      fit = 1 - sqrt(||X||^2 + ||TT||^2 - 2<X, TT>) / ||X||

where l_z / r_z are the left / right interface chains of the other cores at
non-zero z, P_{m-1} the (rl_m, rl_m) left Gram and Q_{m+1} the (rr_m, rr_m)
right Gram.  The right Grams are computed once per sweep from the incoming
cores; the left Gram runs ahead with each freshly solved core.

Core <-> matrix convention, kernels included: the mode-m interface matrix is
W_m = transpose(G_m, (1, 0, 2)).reshape(I_m, rl_m * rr_m), columns row-major
over (rl, rr), matching the kernel's kron(l, r) column order and the
kron(P, Q) normal matrix.

PyTorch runs eagerly, so the sweep is a Python loop over modes where the
reference jits it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..core.coo import SparseTensor, norm_sq, to_device
from ..core.cp_als import _fit_from
from ..core.loop import (
    check_drive_extras,
    check_planned_method,
    check_workspace,
    finish_iter,
    given_factors,
)
from ..core.memctrl import GPUSpec, MemoryControllerConfig
from ..core.pms import predict_tt
from ..device import resolve_device
from ..dist.collective import Replicas, reduce_partials
from ..kernels.ops import (
    PlannedTTCore,
    _fit_streams,
    _resolve_dist,
    _ShardStack,
    _sharded_mode_stack,
    _stack_call,
    _tt_bond_pairs,
    _tuned_cfg,
    make_planned_ttcore,
)
from ..kernels.ref import ttcore_ref
from ..kernels.tt import chain_left, ttcore_blocked
from ..kernels.workspace import PlannedWorkspace, ShardedWorkspace

__all__ = [
    "TTState",
    "tt_als",
    "PlannedTT",
    "make_planned_tt",
    "ShardedPlannedTT",
    "make_sharded_planned_tt",
    "init_tt_cores",
    "tt_svd",
    "core_to_matrix",
    "matrix_to_core",
    "tt_inner",
    "tt_norm_sq",
    "tt_fit_value",
]

# tt_svd densifies the tensor (float64) for the sequential truncated SVD;
# init='auto' takes the random init above this element count.
_TT_SVD_DENSE_LIMIT = 1 << 22

#: Gathered floats per step of `tt_inner`: the 2^22 non-zeros x rank 16 of
#: a CP fit step (`core.cp_als.INNER_CHUNK`), here divided among the lanes
#: of the widest interface row (an unchunked chain at NELL-2 size would
#: gather 77 M x 256 floats of W_1).
INNER_ELEMS = 1 << 26


@dataclasses.dataclass
class TTState:
    cores: list[torch.Tensor]  # one (rl_m, I_m, rr_m) per mode; boundary bonds 1
    fit_history: list[float]

    @property
    def tt_ranks(self) -> tuple[int, ...]:
        """The N-1 interior bond ranks."""
        return tuple(int(c.shape[2]) for c in self.cores[:-1])

    def full(self) -> torch.Tensor:
        """Dense reconstruction (I_0, ..., I_{N-1}): tiny shapes only."""
        out = self.cores[0]  # (1, I_0, r)
        for c in self.cores[1:]:
            out = torch.tensordot(out, c, dims=([-1], [0]))
        return out.reshape(tuple(int(c.shape[1]) for c in self.cores))


def _validated_tt_ranks(st: SparseTensor, tt_ranks: int | Sequence[int]) -> tuple[int, ...]:
    """Normalize and validate the N-1 interior bond ranks (an int
    broadcasts).  Bond k sits between modes k and k+1; its rank cannot
    exceed the matrix rank bound min(prod(I_0..I_k), prod(I_{k+1}..I_{N-1}))."""
    if isinstance(tt_ranks, (int, np.integer)):
        tt_ranks = (int(tt_ranks),) * (st.nmodes - 1)
    tr = tuple(int(r) for r in tt_ranks)
    if len(tr) != st.nmodes - 1:
        raise ValueError(
            f"tt_ranks has {len(tr)} entries for a {st.nmodes}-mode tensor "
            f"(pass the N-1 interior TT ranks, or an int to broadcast)")
    for k, r in enumerate(tr):
        bound = min(math.prod(st.shape[: k + 1]), math.prod(st.shape[k + 1:]))
        if not 1 <= r <= bound:
            raise ValueError(
                f"TT rank {r} for bond {k} (modes {k}|{k + 1}) out of range "
                f"[1, {bound}] (unfolding rank bound)")
    return tr


def core_to_matrix(core: torch.Tensor) -> torch.Tensor:
    """G (rl, I, rr) -> W (I, rl*rr), columns row-major over (rl, rr)."""
    rl, i, rr = core.shape
    return core.permute(1, 0, 2).reshape(i, rl * rr)


def matrix_to_core(w: torch.Tensor, rl: int, rr: int) -> torch.Tensor:
    """W (I, rl*rr) -> G (rl, I, rr), the inverse of `core_to_matrix` (a
    view of w where its strides allow)."""
    return w.reshape(w.shape[0], rl, rr).permute(1, 0, 2)


def init_tt_cores(shape: Sequence[int], tt_ranks: Sequence[int], *, seed: int,
                  device: torch.device) -> list[torch.Tensor]:
    """Random left-orthogonal TT cores: each core's left unfolding (rl*I, rr)
    is the reduced QR of a Gaussian drawn from a
    `torch.Generator(device).manual_seed(seed)` (a plain Gaussian scaled by
    1/sqrt(rr) when rl*I < rr, where no orthonormal frame exists).  These
    numbers differ from the reference's `jax.random` draws for the same
    seed; parity with the reference needs its cores passed as `init_cores`."""
    pairs = _tt_bond_pairs(tuple(int(r) for r in tt_ranks), len(shape))
    gen = torch.Generator(device=device).manual_seed(seed)
    cores = []
    for s, (rl, rr) in zip(shape, pairs):
        m = torch.randn((rl * int(s), rr), generator=gen, device=device)
        if rl * int(s) >= rr:
            m = torch.linalg.qr(m)[0]
        else:
            m = m / math.sqrt(rr)
        cores.append(m.reshape(rl, int(s), rr))
    return cores


def tt_svd(st: SparseTensor, tt_ranks: Sequence[int], *,
           device: str | torch.device | None = None) -> list[torch.Tensor]:
    """TT-SVD init (Oseledets): densify, then peel cores off left to right by
    sequential truncated SVD, on the host in float64 with the reference's
    numpy calls, so both packages get the same cores bit for bit.  A
    rank-deficient unfolding is zero-padded up to the requested bond rank.
    Guarded to prod(shape) <= 2^22 elements; use init='random' beyond.
    The cores land on `device`: CUDA unless given (raises if no GPU is
    present)."""
    tr = _validated_tt_ranks(st, tt_ranks)
    nelem = math.prod(st.shape)
    if nelem > _TT_SVD_DENSE_LIMIT:
        raise ValueError(
            f"tt_svd densifies the tensor: prod(shape)={nelem} exceeds the "
            f"{_TT_SVD_DENSE_LIMIT}-element guard; use init='random'")
    device = resolve_device(device)
    shape, nmodes = st.shape, st.nmodes
    dense = np.zeros(shape, np.float64)
    np.add.at(dense, tuple(st.indices[:, m] for m in range(nmodes)), st.values.astype(np.float64))
    cores: list[np.ndarray] = []
    c = dense.reshape(1, -1)
    rl = 1
    for k in range(nmodes - 1):
        c = c.reshape(rl * shape[k], -1)
        r = tr[k]
        u, s, vt = np.linalg.svd(c, full_matrices=False)
        keep = min(r, s.shape[0])
        u, s, vt = u[:, :keep], s[:keep], vt[:keep]
        if keep < r:
            u = np.concatenate([u, np.zeros((u.shape[0], r - keep))], axis=1)
            s = np.concatenate([s, np.zeros(r - keep)])
            vt = np.concatenate([vt, np.zeros((r - keep, vt.shape[1]))], axis=0)
        cores.append(u.reshape(rl, shape[k], r))
        c = s[:, None] * vt
        rl = r
    cores.append(c.reshape(rl, shape[-1], 1))
    return [torch.tensor(x.astype(np.float32), device=device) for x in cores]


def _p_next(p: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Left-interface Gram recursion: P_m = sum_i G_m[:,i,:]^T P_{m-1}
    G_m[:,i,:], shape (rr_m, rr_m); contiguous, as `torch.kron` needs."""
    return torch.einsum("aib,ac,cid->bd", core, p, core).contiguous()


def _q_prev(q: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Right-interface Gram recursion: Q_m = sum_i G_m[:,i,:] Q_{m+1}
    G_m[:,i,:]^T, shape (rl_m, rl_m); contiguous, as `torch.kron` needs."""
    return torch.einsum("aib,bc,dic->ad", core, q, core).contiguous()


def _q_suffix(cores: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """qs[m] = the right Gram over cores STRICTLY right of m, the Q_{m+1}
    factor of mode m's normal matrix (ones((1, 1)) for the last mode)."""
    qs: list[torch.Tensor] = [None] * len(cores)
    q = torch.ones((1, 1), dtype=cores[-1].dtype, device=cores[-1].device)
    for m in range(len(cores) - 1, -1, -1):
        qs[m] = q
        q = _q_prev(q, cores[m])
    return qs


def _solve_core(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the core normal equations W A = B for W (I, rl*rr), A =
    kron(P, Q) symmetric PSD, by Cholesky; a trace-scaled ridge keeps the
    solve finite when an interface direction has collapsed.  `cholesky_ex`
    does not wait for the device to report a failed factorization: a
    failure shows as a non-finite fit, which stops the drive loop."""
    dim = a.shape[0]
    ridge = 1e-8 * (torch.trace(a) / dim) + 1e-12
    chol, _ = torch.linalg.cholesky_ex(a + ridge * torch.eye(dim, dtype=a.dtype, device=a.device))
    return torch.cholesky_solve(b.T, chol).T


def tt_inner(indices: torch.Tensor, values: torch.Tensor, cores: Sequence[torch.Tensor],
             elems: int = INNER_ELEMS) -> torch.Tensor:
    """<X, TT> over X's non-zeros: per non-zero the left-to-right chain of
    core slices, then the value-weighted sum; in steps of about `elems`
    gathered floats."""
    mats = [core_to_matrix(c) for c in cores]
    widest = max(w.shape[1] for w in mats)
    chunk = max(1, elems // widest)
    total = torch.zeros((), dtype=values.dtype, device=values.device)
    for z0 in range(0, values.shape[0], chunk):
        idx = indices[z0: z0 + chunk]
        v = torch.ones((idx.shape[0], 1), dtype=values.dtype, device=values.device)
        for k, (w, c) in enumerate(zip(mats, cores)):
            v = chain_left(v, w.index_select(0, idx[:, k]).view(-1, c.shape[0], c.shape[2]))
        total = total + torch.sum(values[z0: z0 + chunk] * v[:, 0])
    return total


def tt_norm_sq(cores: Sequence[torch.Tensor]) -> torch.Tensor:
    """||TT||_F^2 via the left Gram recursion: rank-sized intermediates only."""
    p = torch.ones((1, 1), dtype=cores[0].dtype, device=cores[0].device)
    for core in cores:
        p = _p_next(p, core)
    return p[0, 0]


def tt_fit_value(indices: torch.Tensor, values: torch.Tensor, cores: Sequence[torch.Tensor],
                 norm_x_sq: torch.Tensor) -> torch.Tensor:
    """fit = 1 - ||X - TT|| / ||X||, expanded as ||X||^2 + ||TT||^2 -
    2<X, TT>: one pass over the non-zeros, no densification."""
    return _fit_from(norm_x_sq, tt_norm_sq(cores), tt_inner(indices, values, cores))


@dataclasses.dataclass
class PlannedTT(PlannedWorkspace):
    """Per-mode plans driving the whole TT-ALS loop: one `PlannedTTCore` per
    output mode, built once; the drive loop and padding (each mode's
    interface matrix to rank_padded(rl_m * rr_m)) come from
    `PlannedWorkspace`, this class supplies the TT sweep.  Its padded
    factors are the interface MATRICES W_m; `tt_als` folds them back into
    cores at the end."""

    ops: dict[int, PlannedTTCore]
    shape: tuple[int, ...]
    tt_ranks: tuple[int, ...]  # N-1 interior bond ranks

    @property
    def bond_pairs(self) -> tuple[tuple[int, int], ...]:
        return _tt_bond_pairs(self.tt_ranks, self.nmodes)

    @property
    def lane_ranks(self) -> tuple[int, ...]:
        return tuple(a * b for a, b in self.bond_pairs)

    @property
    def device(self) -> torch.device:
        return self.ops[0].plan.device

    def plan_for(self, mode: int):
        return self.ops[mode].plan

    def _geoms(self) -> dict:
        return {m: op.plan for m, op in self.ops.items()}

    def smem_model_bytes(self, spec: GPUSpec = GPUSpec()) -> int:
        """Shared memory per CTA of the widest mode's TT-core launch."""
        return max(op.cfg.tt_launch(spec, op.in_rank_pairs, op.n_left).smem_bytes
                   for op in self.ops.values())

    def pms_estimates(self, spec: GPUSpec | str = GPUSpec()) -> dict:
        """Exact per-mode TT-core PMS estimates from the built plans."""
        return {m: predict_tt(op.plan, self.tt_ranks, op.cfg, spec) for m, op in self.ops.items()}

    def sweep(self, facs, idx, val, norm_x_sq, *, first: bool = False):
        """One TT-ALS iteration in padded space: for each mode, the TT-core
        kernel -> kron(P, Q) normal solve -> core update; then the fit.

        Each mode's new interface matrix is written IN PLACE into the true
        block of its padded tensor (padding rows and lanes stay exactly 0,
        so the next mode's kernel gathers zeros there).  `idx`, `val`: the
        raw COO stream on the device, read only by the fit's inner product;
        `norm_x_sq`: ||X||_F^2 as a device scalar.  `first` is taken for the
        drive loop and ignored.  Returns (padded matrices, None, fit)."""
        shape, pairs, lr = self.shape, self.bond_pairs, self.lane_ranks
        facs = tuple(facs)
        cores = [matrix_to_core(f[:s, :w], *pr) for f, s, w, pr in zip(facs, shape, lr, pairs)]
        qs = _q_suffix(cores)
        p = torch.ones((1, 1), dtype=torch.float32, device=facs[0].device)
        for m in range(self.nmodes):
            op = self.ops[m]
            pl = op.plan
            in_mats = [facs[im][: pl.in_rows[n]] for n, im in enumerate(pl.in_modes)]
            b = ttcore_blocked(pl, in_mats, op.in_rank_pairs, op.n_left)[: shape[m], : lr[m]]
            facs[m][: shape[m], : lr[m]] = _solve_core(torch.kron(p, qs[m]), b)
            cores[m] = matrix_to_core(facs[m][: shape[m], : lr[m]], *pairs[m])
            p = _p_next(p, cores[m])
        return facs, None, _fit_from(norm_x_sq, p[0, 0], tt_inner(idx, val, cores))

    def _build_fallback_sweep(self):
        """The "fallback" guard policy's target: the same left-to-right sweep
        with each mode's kernel replaced by `ttcore_ref` on the raw stream
        (which the drive's arguments carry for the fit), on the same padded
        interface matrices, written in place.  Launches no kernel."""
        shape, pairs, lr, nmodes = self.shape, self.bond_pairs, self.lane_ranks, self.nmodes

        def sweep(facs, idx, val, norm_x_sq, *, it: int):
            facs = tuple(facs)
            cores = [matrix_to_core(f[:s, :w], *pr) for f, s, w, pr in zip(facs, shape, lr, pairs)]
            qs = _q_suffix(cores)
            p = torch.ones((1, 1), dtype=torch.float32, device=facs[0].device)
            for m in range(nmodes):
                b = ttcore_ref(idx, val, cores, m, shape[m])
                facs[m][: shape[m], : lr[m]] = _solve_core(torch.kron(p, qs[m]), b)
                cores[m] = matrix_to_core(facs[m][: shape[m], : lr[m]], *pairs[m])
                p = _p_next(p, cores[m])
            return facs, None, _fit_from(norm_x_sq, p[0, 0], tt_inner(idx, val, cores))

        return sweep


def make_planned_tt(
    st: SparseTensor,
    tt_ranks: int | Sequence[int],
    *,
    cfg: MemoryControllerConfig | None = None,
    auto_tune: bool | str = False,
    spec: GPUSpec | str = GPUSpec(),
    device: str | torch.device | None = None,
) -> PlannedTT:
    """Build the TT-ALS workspace: one TT-core plan per output mode on
    `device` (CUDA unless given), all with `cfg` (or the default), or each
    at the PMS's pick for the TT-core kernel with auto_tune=True or
    "cached"."""
    tr = _validated_tt_ranks(st, tt_ranks)
    device = resolve_device(device)
    ops = {m: make_planned_ttcore(st, m, tr, cfg=cfg, auto_tune=auto_tune, spec=spec, device=device)
           for m in range(st.nmodes)}
    return PlannedTT(ops=ops, shape=st.shape, tt_ranks=tr)


@dataclasses.dataclass
class ShardedPlannedTT(ShardedWorkspace):
    """The TT-ALS loop on the sharded planned path: the TT-core mirror of
    `ShardedPlannedCPALS` (the same partitions and shard stacks, the TT-core
    kernel once per shard, one reduction per mode into B_m, the
    normal-equations solve on the first shard's device and the new
    interface matrix copied to the others).  The fit adds each shard's
    <X, TT> over its slice of mode 0's partition (`fit_streams`);
    ||TT||^2 is the completed left-interface chain."""

    stacks: dict
    dist: object  # ShardingPlan
    shape: tuple[int, ...]
    tt_ranks: tuple[int, ...]  # N-1 interior bond ranks
    cfgs: dict
    fit_streams: tuple

    @property
    def bond_pairs(self) -> tuple[tuple[int, int], ...]:
        return _tt_bond_pairs(self.tt_ranks, self.nmodes)

    @property
    def lane_ranks(self) -> tuple[int, ...]:
        return tuple(a * b for a, b in self.bond_pairs)

    def in_rank_pairs(self, mode: int) -> tuple[tuple[int, int], ...]:
        pairs = self.bond_pairs
        return tuple(pairs[im] for im in self.stacks[mode].in_modes)

    def sweep(self, facs, norm_x_sq, *, first: bool = False):
        """One TT-ALS iteration in padded space: `PlannedTT.sweep` with each
        mode's TT-core kernel launched once per shard and reduced, and the
        fit's inner product over the shards' slices.  Returns (padded
        matrices, None, fit)."""
        shape, pairs, lr = self.shape, self.bond_pairs, self.lane_ranks
        facs = tuple(facs)
        reps = Replicas(facs, self.dist.devices)
        cores = [matrix_to_core(f[:s, :w], *pr) for f, s, w, pr in zip(facs, shape, lr, pairs)]
        qs = _q_suffix(cores)
        p = torch.ones((1, 1), dtype=torch.float32, device=facs[0].device)
        for m in range(self.nmodes):
            b = reduce_partials(_stack_call(self.stacks[m], ttcore_blocked, reps,
                                             self.in_rank_pairs(m), m))
            facs[m][: shape[m], : lr[m]] = _solve_core(torch.kron(p, qs[m]), b[: shape[m], : lr[m]])
            reps.refresh(m)
            cores[m] = matrix_to_core(facs[m][: shape[m], : lr[m]], *pairs[m])
            p = _p_next(p, cores[m])
        inner = reduce_partials([
            tt_inner(idx, val, [matrix_to_core(f[:s, :w], *pr)
                                for f, s, w, pr in zip(reps.on(idx.device), shape, lr, pairs)])
            for idx, val in self.fit_streams])
        return facs, None, _fit_from(norm_x_sq, p[0, 0], inner)


def make_sharded_planned_tt(
    st: SparseTensor,
    tt_ranks: int | Sequence[int],
    *,
    dist=None,
    devices=None,
    cfg: MemoryControllerConfig | None = None,
    auto_tune: bool | str = False,
    spec: GPUSpec | str = GPUSpec(),
) -> ShardedPlannedTT:
    """Build the sharded TT-ALS workspace: one partition and shard stack per
    output mode, on `dist` or `shard_plan(devices)`; with auto_tune each
    mode's configuration is the sharded PMS's pick for the TT-core
    kernel."""
    tr = _validated_tt_ranks(st, tt_ranks)
    dist = _resolve_dist(dist, devices)
    stacks: dict[int, _ShardStack] = {}
    cfgs: dict[int, MemoryControllerConfig] = {}
    part0 = None
    for m in range(st.nmodes):
        cfgs[m] = _tuned_cfg(st, m, tr, dist.dp_size(), cfg, auto_tune, spec, kernel="tt")
        part, stacks[m] = _sharded_mode_stack(st, m, cfgs[m], dist, "tt")
        if m == 0:
            part0 = part
    return ShardedPlannedTT(stacks=stacks, dist=dist, shape=st.shape, tt_ranks=tr, cfgs=cfgs,
                            fit_streams=_fit_streams(st, part0, dist, cfgs[0].cache.tile_i))


def _initial_cores(st: SparseTensor, tr: tuple[int, ...], init: str, init_cores, seed: int,
                   device: torch.device) -> list[torch.Tensor]:
    if init not in ("auto", "svd", "random"):
        raise ValueError(f"unknown init {init!r}: expected 'auto', 'svd' or 'random'")
    pairs = _tt_bond_pairs(tr, st.nmodes)
    if init_cores is not None:
        if init != "auto":
            raise ValueError(f"init={init!r} and init_cores: pass one of them")
        return given_factors(init_cores, [(rl, s, rr) for s, (rl, rr) in zip(st.shape, pairs)],
                             device, what="core")
    if init == "auto":
        init = "svd" if math.prod(st.shape) <= _TT_SVD_DENSE_LIMIT else "random"
    if init == "svd":
        return tt_svd(st, tr, device=device)
    return init_tt_cores(st.shape, tr, seed=seed, device=device)


def tt_als(
    st: SparseTensor,
    tt_ranks: int | Sequence[int],
    *,
    iters: int = 10,
    method: str = "pallas",
    init: str = "auto",
    init_cores: Sequence | None = None,
    seed: int = 0,
    tol: float | None = None,
    planned: PlannedTT | None = None,
    auto_tune: bool | str = False,
    spec: GPUSpec | str = "default",
    cfg: MemoryControllerConfig | None = None,
    device: str | torch.device | None = None,
    devices=None,
    dist=None,
    verbose: bool = False,
    guards=None,
    checkpoint_every: int | None = None,
    checkpoint_path=None,
) -> TTState:
    """Run sparse tensor-train ALS.

    tt_ranks: the N-1 interior bond ranks (an int broadcasts).
    method: 'pallas' (the name the reference gives its planned path): a
      `PlannedTT` workspace is built once (one device-resident BlockPlan per
      output mode) and every right-hand side runs through the TT-core
      kernel; 'pallas_sharded': the sharded planned path
      (`make_sharded_planned_tt`, placed by `devices=` / `dist=` as in
      `cp_als`); 'reference' — `ttcore_ref` on the raw COO stream.
    init: 'svd' — the deterministic TT-SVD warm start (densifies; guarded to
      2^22 elements), the same cores as the reference's; 'random' —
      left-orthogonal random cores from a torch generator seeded with
      `seed` (not the reference's numbers); 'auto' — SVD when the guard
      allows, else random.
    init_cores: one (rl_m, I_m, rr_m) array or tensor per mode (e.g. the
      reference's `init_tt_cores`), in place of `init`.
    planned: a prebuilt `PlannedTT` (`make_planned_tt`, which also takes the
      plan geometry), or `ShardedPlannedTT` for 'pallas_sharded', to reuse
      its plans across calls.
    auto_tune / spec / cfg: the workspace's plan geometry when `planned` is
      not given: `cfg` for every mode, or the PMS's pick per mode for the
      TT-core kernel (auto_tune=True; "cached" keeps the winners on disk).
    device: CUDA unless the caller passes one (raises if no GPU is present).
    guards / checkpoint_every / checkpoint_path: the planned drive loop's
      resilience surface (`repro_torch.resilience`; see `cp_als`).
      The planned paths only.
    """
    tr = _validated_tt_ranks(st, tt_ranks)
    if method not in ("pallas", "pallas_sharded", "reference"):
        raise ValueError(f"unknown method {method!r}: expected 'pallas', 'pallas_sharded' or "
                         f"'reference'")
    check_planned_method(method, planned, devices, dist)
    check_drive_extras(method, guards, checkpoint_every, checkpoint_path)
    pairs = _tt_bond_pairs(tr, st.nmodes)
    if method == "pallas_sharded":
        if device is not None:
            raise ValueError("method='pallas_sharded' places its shards by devices=/dist=; "
                             "device= would be silently ignored")
        if planned is None:
            planned = make_sharded_planned_tt(st, tr, dist=dist, devices=devices, cfg=cfg,
                                              auto_tune=auto_tune, spec=spec)
        else:
            check_workspace(planned, ShardedPlannedTT, {"shape": st.shape, "tt_ranks": tr},
                            method=method, devices=devices, dist=dist)
        cores = _initial_cores(st, tr, init, init_cores, seed, planned.device)
        norm_x_sq = torch.tensor(norm_sq(st), dtype=torch.float32, device=planned.device)
        mats, _, fits = planned.drive(
            [core_to_matrix(c) for c in cores], (norm_x_sq,), iters=iters, tol=tol,
            verbose=verbose, label="tt_als",
            guards=guards, checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path)
        return TTState(cores=[matrix_to_core(w, *pr).contiguous() for w, pr in zip(mats, pairs)],
                       fit_history=fits)
    device = resolve_device(device)
    if planned is not None:
        check_workspace(planned, PlannedTT, {"shape": st.shape, "tt_ranks": tr}, device,
                        method=method)
    cores = _initial_cores(st, tr, init, init_cores, seed, device)
    if method == "pallas" and planned is None:
        planned = make_planned_tt(st, tr, cfg=cfg, auto_tune=auto_tune, spec=spec, device=device)
    # The stream moves to the device after the plan build, whose
    # temporaries set the peak device memory.
    idx, val = to_device(st, device)
    norm_x_sq = torch.tensor(norm_sq(st), dtype=torch.float32, device=device)

    if method == "pallas":
        mats, _, fits = planned.drive(
            [core_to_matrix(c) for c in cores], (idx, val, norm_x_sq), iters=iters, tol=tol,
            verbose=verbose, label="tt_als",
            guards=guards, checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path)
        return TTState(cores=[matrix_to_core(w, *pr).contiguous() for w, pr in zip(mats, pairs)],
                       fit_history=fits)

    fits: list[float] = []
    for it in range(iters):
        qs = _q_suffix(cores)
        p = torch.ones((1, 1), dtype=torch.float32, device=device)
        for m in range(st.nmodes):
            b = ttcore_ref(idx, val, cores, m, st.shape[m])
            w = _solve_core(torch.kron(p, qs[m]), b)
            cores[m] = matrix_to_core(w, *pairs[m]).contiguous()
            p = _p_next(p, cores[m])
        if finish_iter(fits, tt_fit_value(idx, val, cores, norm_x_sq), it, tol, verbose, "tt_als"):
            break
    return TTState(cores=cores, fit_history=fits)
