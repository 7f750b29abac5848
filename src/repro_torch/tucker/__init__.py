"""Sparse Tucker decomposition (HOOI) on the planned TTM-chain kernel, which
runs on the same BlockPlan layout as MTTKRP (see kernels/ttm.py)."""
from ..kernels.ops import PlannedTTMC, make_planned_ttmc
from .hooi import (
    PlannedTucker,
    TuckerState,
    core_fit_value,
    init_tucker_factors,
    make_planned_tucker,
    tucker_hooi,
)

__all__ = [
    "TuckerState",
    "tucker_hooi",
    "PlannedTucker",
    "make_planned_tucker",
    "init_tucker_factors",
    "core_fit_value",
    "PlannedTTMC",
    "make_planned_ttmc",
]
