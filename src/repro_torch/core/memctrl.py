"""Programmable memory-controller configuration (paper Sec. 5), for Hopper.

Counterpart of `repro.core.memctrl`.  The dataclasses carry the BlockPlan
geometry (`tile_i`, the input tiles, `blk`) and the Remapper's element
widths; `GPUSpec` takes the place of the reference's `TPUSpec`.  The
reference's VMEM model (a resident output tile and input factor tiles,
double-buffered) does not describe the port's kernels: they keep no factor
tile on chip, read factor rows from L2, and hold in shared memory only
what their own layout says.  So the fit check here is shared memory per
CTA, computed from each kernel's layout (`KernelLaunch`):

  * MTTKRP (`csrc/mttkrp.cu`, `smem_bytes` and the constants at the top):
    the warps' first and last runs and the CTA's carried run ((2 x 8 warps
    + 1) x G lanes x NQ quads of 16 bytes), 2,048 sorted slots (16 bytes
    each for 2 input modes, 24 for 3 or 4) and one int of row counts per
    tile row;
  * TTMc (`csrc/ttmc.cu`): the warps' edges (8 x 2 x NQ x 32 float4s) and
    the row counts, beside a static 16 KB permutation;
  * TT-core (`csrc/ttcore.cu`, `launch`): a rows x slice tile of partial
    sums, as many staged slots as the rest of the budget holds (at most
    256), the warps' chain vectors and the row counts, beside the static
    slot fields.

Plans of more than 4 input modes (tensors of 6 or more modes) launch each
kernel's wide path (`wide_launch` in each source), whose layout differs:
MTTKRP keeps the sorted chunk as arrays of (2 + n_in) ints a slot, TTMc
adds each quad's leading digits ((n_in - 1) x NQ x 32 ints) and keeps its
permutation in dynamic shared memory, TT-core keeps its slot fields (n_in
row offsets, a value and a tile row) there too; each stages as many slots
as the budget holds, up to its template's count, and builds for 2 CTAs per
SM.

Each also reports the row parts and column slices a geometry forces
(`blocked.cuh::launch_ranges` runs one CTA per (block range, part,
slice)); each part and slice reads its block range's stream and sorts it
again.  And it reports two shares of the CTAs' work a geometry costs:
`occupancy`, the CTAs per SM its shared memory leaves (an SM's shared
memory over the CTA's, with the 1 KB CUDA reserves for each CTA) as a
share of those the kernel keeps registers for (`__launch_bounds__`), and,
for the TT-core kernel, whose steps never span plan blocks, `step_share`,
the share of a CTA's 256 threads a step's slots keep busy.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "CacheEngineConfig",
    "DMAEngineConfig",
    "RemapperConfig",
    "MemoryControllerConfig",
    "GPUSpec",
    "KernelLaunch",
    "spec_to_dict",
    "spec_from_dict",
    "config_to_dict",
    "config_from_dict",
]

# The kernels' own constants (csrc/blocked.cuh, mttkrp.cu, ttmc.cu, ttcore.cu).
_THREADS = 256
_WARPS = _THREADS // 32
_QUAD = 4  # floats in a quad (one float4)
_MAX_ROWS = 4096  # MTTKRP and TTMc: tile rows per CTA before row parts
_RANGE_BLOCKS = 64  # most plan blocks a CTA's range takes (blocked.cuh kBlocksPerCta)
_MAX_TEMPLATE_IN = 4  # input modes the kernels' templates take; more launch the wide path
_WIDE_CTAS_PER_SM = 2  # the wide kernels' __launch_bounds__
_MTTKRP_SORT_SLOTS = 2048
_MTTKRP_STATIC = (2 * _WARPS + 1 + _WARPS) * 4  # s_run_row (with the carry's row), s_warp
_TTMC_SORT_SLOTS = 8192  # 16-bit offsets
_TTMC_EDGE_STATIC = 2 * _WARPS * 4 + _WARPS * 4  # s_edge_row, s_warp
_TTMC_STATIC = _TTMC_SORT_SLOTS * 2 + _TTMC_EDGE_STATIC  # and the templates' static s_perm
_TT_CHUNK = _THREADS  # most slots per step
_TT_TILE_BYTES = 64 * 1024  # largest tile before row parts
_TT_MIN_SLICE = 8
_TT_GROUP = 8  # lanes per slot in the register path
_TT_GROUP_K = 8  # float4s of a matrix row per lane there
_SMEM_RESERVED = 1024  # shared memory CUDA reserves for each CTA


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round4(x: int) -> int:
    return _ceil_div(x, 4) * 4


def _mttkrp_sorted_bytes(n_in: int) -> int:
    """Shared-memory bytes of one sorted slot of the MTTKRP kernel: a row,
    a value and n_in factor rows, 4 bytes each; the templates' struct
    (`Sorted<N_IN>`) aligns to 16 bytes for 2 inputs and to 8 otherwise,
    the wide path's arrays not at all."""
    raw = 4 * (2 + n_in)
    if n_in > _MAX_TEMPLATE_IN:
        return raw
    align = 16 if n_in == 2 else 8
    return _ceil_div(raw, align) * align


def _staged(budget: int, fixed: int, slot: int, most: int) -> int:
    """Slots a wide launch stages at once: as many as the budget holds
    beside `fixed` bytes, at most `most`; 0 where not one fits."""
    return min(most, (budget - fixed) // slot) if fixed + slot <= budget else 0


@dataclasses.dataclass(frozen=True)
class CacheEngineConfig:
    tile_i: int = 256  # output-tile rows
    tile_j: int = 256  # first input mode's tile rows
    tile_k: int = 256  # every further input mode's tile rows

    def input_tiles(self, n_in: int = 2) -> tuple[int, ...]:
        """Per-input-mode tile sizes for an N-mode tensor: the first input
        mode uses tile_j, every further one tile_k."""
        if n_in < 1:
            raise ValueError(f"n_in must be >= 1, got {n_in}")
        return ((self.tile_j,) + (self.tile_k,) * (n_in - 1))[:n_in]


@dataclasses.dataclass(frozen=True)
class DMAEngineConfig:
    blk: int = 256  # non-zero slots per plan block


@dataclasses.dataclass(frozen=True)
class RemapperConfig:
    pointer_budget: int = 1 << 20
    index_bytes: int = 4
    value_bytes: int = 4


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """Target-hardware constants: NVIDIA H100 SXM5 80 GB data-sheet values
    at its 700 W power limit, not measured (`repro_torch.tune` fits the two
    rates the PMS reads to the card at hand).  `smem_per_block` is the
    opt-in dynamic shared memory of one block (227 KB), `smem_per_sm` an
    SM's shared memory."""

    peak_flops: float = 989e12  # bf16, dense, tensor cores
    peak_flops_f32: float = 67e12  # fp32 outside the tensor cores
    hbm_bw: float = 3.35e12  # bytes/s
    # L2 read rate, bytes/s.  NVIDIA's H100 data sheet and whitepaper give
    # none; this is the A100 whitepaper's L2 read rate, 5,120 bytes a clock
    # ("NVIDIA A100 Tensor Core GPU Architecture", 2020), at the H100 SXM5's
    # 1,980 MHz boost clock (H100 whitepaper).  Not measured.
    l2_bw: float = 5120 * 1.98e9
    smem_per_block: int = 232_448
    smem_per_sm: int = 233_472  # 228 KB
    sms: int = 132
    l2_bytes: int = 50 * 1024**2
    hbm_bytes: int = 80 * 1024**3


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """What one kernel launch takes at a geometry and width: shared memory
    per CTA (dynamic and static), the row parts and column slices it runs a
    block range in, whether it fits the spec's shared memory, the share of
    its CTAs per SM that shared memory leaves, and the share of a CTA's
    threads a step keeps busy, and the CTAs an SM holds at once."""

    smem_bytes: int
    row_parts: int
    col_slices: int
    fits: bool
    occupancy: float = 1.0
    step_share: float = 1.0
    ctas_per_sm: int = 1

    @property
    def slices(self) -> int:
        """CTAs per block range: each reads the range's stream."""
        return self.row_parts * self.col_slices


def _resident(spec: GPUSpec, smem: int, ctas_per_sm: int) -> dict:
    """The CTAs per SM that `smem` bytes each leave, at most the
    `ctas_per_sm` the kernel keeps registers for, and their share of those:
    the `ctas_per_sm` and `occupancy` fields of a `KernelLaunch`."""
    held = min(ctas_per_sm, spec.smem_per_sm // (smem + _SMEM_RESERVED))
    return {"occupancy": held / ctas_per_sm, "ctas_per_sm": max(1, held)}


@dataclasses.dataclass(frozen=True)
class MemoryControllerConfig:
    cache: CacheEngineConfig = CacheEngineConfig()
    dma: DMAEngineConfig = DMAEngineConfig()
    remapper: RemapperConfig = RemapperConfig()

    def _row_parts(self) -> tuple[int, int]:
        """MTTKRP and TTMc: row parts of at most 4,096 rows, and their rows."""
        parts = _ceil_div(self.cache.tile_i, _MAX_ROWS)
        return parts, _ceil_div(self.cache.tile_i, parts)

    def mttkrp_launch(self, spec: GPUSpec, ld: int, n_in: int = 2) -> KernelLaunch:
        """The MTTKRP kernel on factors of `ld` columns (the padded rank)
        with `n_in` >= 2 input modes (`launch_width` and `launch` in
        csrc/mttkrp.cu, or its wide path past 4 inputs): groups of G lanes
        holding NQ quads each."""
        if n_in < 2:
            raise ValueError(f"the kernel takes 2 or more input modes, got {n_in}")
        nquads = _ceil_div(ld, _QUAD)
        if nquads <= 32:
            g, nq = next(g for g in (4, 8, 16, 32) if nquads <= g), 1
        else:
            g, nq = 32, next((q for q in (2, 4) if nquads <= 32 * q), 8)
        parts, rows = self._row_parts()
        fixed = (2 * _WARPS + 1) * g * nq * 16 + rows * 4
        slot = _mttkrp_sorted_bytes(n_in)
        slices = _ceil_div(nquads, g * nq)
        if n_in <= _MAX_TEMPLATE_IN:
            smem = fixed + _MTTKRP_SORT_SLOTS * slot + _MTTKRP_STATIC
            return KernelLaunch(smem, parts, slices, smem <= spec.smem_per_block,
                                **_resident(spec, smem, 4 if n_in == 2 and nq == 1 else 2))
        budget = spec.smem_per_block - _MTTKRP_STATIC
        chunk = _staged(budget, fixed, slot, _MTTKRP_SORT_SLOTS)
        smem = fixed + chunk * slot + _MTTKRP_STATIC
        return KernelLaunch(smem, parts, slices, chunk > 0,
                            **_resident(spec, smem, _WIDE_CTAS_PER_SM))

    def ttmc_launch(self, spec: GPUSpec, in_ranks: tuple[int, ...]) -> KernelLaunch:
        """The TTMc kernel at input ranks `in_ranks` (`launch_quads` and
        `launch` in csrc/ttmc.cu, or its wide path past 4 inputs): each lane
        holds NQ quads of the row."""
        n_in = len(in_ranks)
        r_last = int(in_ranks[-1])
        nquads = (math.prod(int(r) for r in in_ranks) // r_last) * _ceil_div(r_last, _QUAD)
        nq = next((q for q in (1, 2, 4) if nquads <= 32 * q), 8)
        parts, rows = self._row_parts()
        slices = _ceil_div(nquads, 32 * nq)
        fixed = _WARPS * 2 * nq * 32 * 16 + rows * 4
        if n_in <= _MAX_TEMPLATE_IN:
            smem = fixed + _TTMC_STATIC
            return KernelLaunch(smem, parts, slices, smem <= spec.smem_per_block,
                                **_resident(spec, smem, 4 if nq <= 2 else 2))
        fixed += (n_in - 1) * nq * 32 * 4  # the quads' leading digits
        chunk = _staged(spec.smem_per_block - _TTMC_EDGE_STATIC, fixed, 2, _TTMC_SORT_SLOTS)
        smem = fixed + chunk * 2 + _TTMC_EDGE_STATIC
        return KernelLaunch(smem, parts, slices, chunk > 0,
                            **_resident(spec, smem, _WIDE_CTAS_PER_SM))

    def tt_launch(self, spec: GPUSpec, in_pairs: tuple[tuple[int, int], ...],
                  n_left: int) -> KernelLaunch:
        """The TT-core kernel at input bond pairs `in_pairs` with `n_left`
        inputs chained from the left (`ttcore_blocked_launch` and `launch`
        in csrc/ttcore.cu, or its wide path past 4 inputs, whose slot
        fields are dynamic and whose chains all take the warp path): the
        tile's slice and row parts, then as many staged slots as fit (at
        most 256).  Does not fit where not one staged slot fits beside a
        1-row tile.  A step takes at most that many slots of one plan
        block."""
        n_in = len(in_pairs)
        rl = [int(a) for a, _ in in_pairs]
        rr = [int(b) for _, b in in_pairs]
        rl_m = rr[n_left - 1] if n_left > 0 else 1
        rr_m = rl[n_left] if n_left < n_in else 1
        ncols = rl_m * rr_m

        def group_step_ok(n: int) -> bool:  # quad steps with rr / 4 dividing 32
            rr4 = rr[n] // 4
            return (rr[n] % 4 == 0 and 1 <= rr4 <= _TT_GROUP and 32 % rr4 == 0
                    and rl[n] * rr4 <= _TT_GROUP * _TT_GROUP_K)

        wide = n_in > _MAX_TEMPLATE_IN
        copy = n_in == 2 and n_left == 1
        group = (not copy and not wide and n_left <= 2 and n_in - n_left <= 2
                 and (n_left < 2 or group_step_ok(1)) and (n_in - n_left < 2 or group_step_ok(n_in - 2)))
        maxw4 = 0 if copy or group else _round4(max([1] + rl + rr))
        stage4 = _round4(rl_m) + _round4(rr_m)
        max_slice = 4 * _THREADS if rr_m % 4 == 0 else _THREADS
        slice_ = _TT_MIN_SLICE
        while slice_ < ncols and slice_ < max_slice:
            slice_ *= 2
        # The slot fields (s_in, s_val, s_row): static in the templates,
        # dynamic beside each staged slot in the wide path; and s_warp.
        fields = n_in * 8 + 2 * 4
        static = (0 if wide else _TT_CHUNK * fields) + _WARPS * 4
        budget = max(0, spec.smem_per_block - static)

        def dyn(parts: int, chunk: int) -> int:
            rows = _ceil_div(self.cache.tile_i, parts)
            return ((rows * slice_ + chunk * stage4 + _WARPS * 2 * maxw4) * 4 + rows * 4
                    + (chunk * fields if wide else 0))

        tile_i = self.cache.tile_i
        parts = 1
        while parts < tile_i and _ceil_div(tile_i, parts) * slice_ * 4 > _TT_TILE_BYTES:
            parts *= 2
        slot = stage4 * 4 + (fields if wide else 0)
        while parts < tile_i and dyn(parts, 0) + slot > budget:
            parts *= 2
        used = dyn(parts, 0)
        fits = used + slot <= budget
        chunk = min((budget - used) // slot, _TT_CHUNK) if fits else 0
        smem = dyn(parts, chunk) + static
        return KernelLaunch(smem, parts, _ceil_div(ncols, slice_), fits,
                            step_share=min(chunk, self.dma.blk) / _THREADS,
                            **_resident(spec, smem, _WIDE_CTAS_PER_SM if wide else 4))


# ---------------------------------------------------------------------------
# JSON-ready (de)serialization, for the autotune cache (repro_torch.tune).
# ---------------------------------------------------------------------------


def _from_known_fields(cls, d: dict):
    """Rebuild a dataclass from a plain dict, rejecting unknown keys (an
    entry written by another code version reads as invalid, not as
    silence)."""
    if not isinstance(d, dict):
        raise ValueError(f"{cls.__name__}: expected a dict, got {type(d).__name__}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**d)


def spec_to_dict(spec: GPUSpec) -> dict:
    """GPUSpec -> plain JSON-ready dict."""
    return dataclasses.asdict(spec)


def spec_from_dict(d: dict) -> GPUSpec:
    """Plain dict -> GPUSpec.  Raises ValueError on unknown fields."""
    return _from_known_fields(GPUSpec, d)


def config_to_dict(cfg: MemoryControllerConfig) -> dict:
    """MemoryControllerConfig -> nested JSON-ready dict."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> MemoryControllerConfig:
    """Nested dict -> MemoryControllerConfig.  Raises ValueError on unknown
    fields at any level."""
    if not isinstance(d, dict):
        raise ValueError(f"config: expected a dict, got {type(d).__name__}")
    unknown = set(d) - {"cache", "dma", "remapper"}
    if unknown:
        raise ValueError(f"config: unknown fields {sorted(unknown)}")
    return MemoryControllerConfig(
        cache=_from_known_fields(CacheEngineConfig, d.get("cache", {})),
        dma=_from_known_fields(DMAEngineConfig, d.get("dma", {})),
        remapper=_from_known_fields(RemapperConfig, d.get("remapper", {})),
    )
