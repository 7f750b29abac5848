"""Host substrate and CP-ALS driver of the port (mirrors `repro.core`): the
COO container and generators, the paper's compute patterns and traffic
model, the Tensor Remapper, the memory-controller configurations, the PMS
and the CP-ALS driver.  `GPUSpec` takes the place of `TPUSpec`.

The exports resolve on first use: the kernel modules import `core.remap`,
and the PMS imports the kernel modules."""
from .._lazy import lazy_attrs

_EXPORTS = {
    ".coo": ("SparseTensor", "CooBatch", "synthetic_tensor", "frostt_like", "to_device", "random_factors"),
    ".hypergraph": ("TrafficModel", "approach1_traffic", "approach2_traffic", "remap_overhead", "stats"),
    ".remap": ("remap_stable", "remap_pointer_machine", "remap_radix", "radix_digits", "plan_blocks",
               "plan_blocks_reference", "BlockPlan", "pointer_table", "group_key"),
    ".mttkrp": ("mttkrp", "mttkrp_approach1", "mttkrp_approach2", "mttkrp_sharded", "hadamard_rows"),
    ".memctrl": ("MemoryControllerConfig", "CacheEngineConfig", "DMAEngineConfig", "RemapperConfig", "GPUSpec"),
    ".pms": ("PMSEstimate", "ShardedPMSEstimate", "predict_from_plan", "predict_analytic", "predict_sharded",
             "search", "search_sharded"),
    ".cp_als": ("cp_als", "CPState", "fit_value", "gram_hadamard"),
}

__all__ = [name for names in _EXPORTS.values() for name in names]
__getattr__ = lazy_attrs(__name__, {name: mod for mod, names in _EXPORTS.items() for name in names})
