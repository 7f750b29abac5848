"""Sparse tensor-train decomposition (TT-ALS) on the planned TT-core kernel,
which runs on the same BlockPlan layout as MTTKRP and TTMc (see
kernels/tt.py); `tt_auto` is the one-shot dispatcher sharing the plan
cache of kernels/ops.py."""
from ..kernels.ops import PlannedTTCore, make_planned_ttcore, tt_auto
from .als import (
    PlannedTT,
    TTState,
    core_to_matrix,
    init_tt_cores,
    make_planned_tt,
    matrix_to_core,
    tt_als,
    tt_fit_value,
    tt_inner,
    tt_norm_sq,
    tt_svd,
)

__all__ = [
    "TTState",
    "tt_als",
    "PlannedTT",
    "make_planned_tt",
    "init_tt_cores",
    "tt_svd",
    "core_to_matrix",
    "matrix_to_core",
    "tt_inner",
    "tt_norm_sq",
    "tt_fit_value",
    "PlannedTTCore",
    "make_planned_ttcore",
    "tt_auto",
]
