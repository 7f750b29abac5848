"""Kernels of the port (mirrors `repro.kernels`): the hand-written Hopper
MTTKRP kernel, its build, its plain PyTorch version, and the planned
workspaces that drive it."""
