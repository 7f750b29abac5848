"""PyTorch/CUDA port of the programmable-memory-controller decomposition
system (the JAX package `repro` is the reference it is held against).

Planned CP-ALS, Tucker HOOI and TT-ALS run end to end: the Tensor Remapper
builds one `BlockPlan` per output mode with torch ops on the device;
hand-written Hopper CUDA kernels compute each mode's MTTKRP
(`kernels/csrc/mttkrp.cu`), TTM chain (`kernels/csrc/ttmc.cu`) and TT-core
right-hand side (`kernels/csrc/ttcore.cu`); `api.decompose(st, rank,
format="cp" | "tucker" | "tt")` drives the CP-ALS, HOOI or TT-ALS loop.
The Performance Model Simulator (`core/pms.py`) prices plan geometries for
those kernels on an H100 and picks one per mode with `auto_tune=True`;
`tune/` keeps the picks and fits the model's rates to the card.  Beside
the planned paths run the JAX package's non-planned methods: the paper's
two MTTKRP compute patterns on the raw stream (`method="approach1"` over
the stream the Tensor Remapper sorts on the device, `"approach2"`), Tucker
and TT `method="reference"`, and the one-shot dispatchers `mttkrp_auto`,
`tucker_auto` and `tt_auto` with their plan cache (`kernels/ops.py`).

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
GPU and no device given they raise instead of falling back to the CPU.
"""
