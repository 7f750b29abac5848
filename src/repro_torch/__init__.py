"""PyTorch/CUDA port of the programmable-memory-controller decomposition
system (the JAX package `repro` is the reference it is held against).

Planned CP-ALS and Tucker HOOI run end to end: the Tensor Remapper builds
one `BlockPlan` per output mode with torch ops on the device; hand-written
Hopper CUDA kernels compute each mode's MTTKRP (`kernels/csrc/mttkrp.cu`)
and TTM chain (`kernels/csrc/ttmc.cu`); `api.decompose(st, rank,
format="cp" | "tucker")` drives the ALS or HOOI loop.

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
GPU and no device given they raise instead of falling back to the CPU.
"""
