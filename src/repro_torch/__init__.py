"""PyTorch/CUDA port of the programmable-memory-controller decomposition
system (the JAX package `repro` is the reference it is held against).

Slice 1 covers planned CP-ALS end to end: the Tensor Remapper builds one
`BlockPlan` per output mode with torch ops on the device, a hand-written
Hopper CUDA kernel (`kernels/csrc/mttkrp.cu`) computes each mode's MTTKRP,
and `api.decompose(st, rank, format="cp")` drives the ALS loop.

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
GPU and no device given they raise instead of falling back to the CPU.
"""
