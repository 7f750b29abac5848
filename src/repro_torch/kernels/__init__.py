"""Kernels of the port (mirrors `repro.kernels`): the hand-written Hopper
MTTKRP, TTM-chain and TT-core kernels (`mttkrp`, `ttm`, `tt`, built by
`build`) with their plain PyTorch versions, the shared `PlannedWorkspace` /
`ShardedWorkspace` protocol (`workspace`), plan construction and dispatch
(`ops`) and the oracles (`ref`).  `mttkrp_blocked`, `ttmc_blocked` and
`ttcore_blocked` take the place of the reference's three `*_pallas_call`.

The exports resolve on first use: `ops` imports `core`, whose PMS imports
the kernel modules."""
from .._lazy import lazy_attrs

_EXPORTS = {
    ".mttkrp": ("mttkrp_blocked", "pad_factor", "rank_padded"),
    ".ttm": ("ttmc_blocked", "cols_padded", "kron_cols"),
    ".tt": ("ttcore_blocked", "tt_out_pair", "tt_out_cols"),
    ".workspace": ("PlannedWorkspace", "ShardedWorkspace", "planned_layout_bytes", "sharded_layout_bytes"),
    ".ops": ("PlannedCPALS", "PlannedMTTKRP", "PlannedTTMC", "PlannedTTCore", "ShardedPlannedCPALS",
             "ShardedPlannedMTTKRP", "ShardedPlannedTucker", "ShardedPlannedTT", "make_planned_cp_als",
             "make_planned_mttkrp", "make_planned_ttmc", "make_planned_ttcore", "make_sharded_planned_cp_als",
             "make_sharded_planned_mttkrp", "make_sharded_planned_tucker", "make_sharded_planned_tt", "mttkrp_auto",
             "tucker_auto", "tt_auto", "plan_cache_clear", "plan_cache_stats", "planned_padded_rows"),
    ".ref": ("mttkrp_ref", "mttkrp_ref_dense", "mttkrp_plan_ref", "ttmc_ref", "ttmc_ref_dense", "ttmc_plan_ref",
             "ttcore_ref", "ttcore_ref_dense", "ttcore_plan_ref"),
}

__all__ = [name for names in _EXPORTS.values() for name in names]
__getattr__ = lazy_attrs(__name__, {name: mod for mod, names in _EXPORTS.items() for name in names})
