"""Kernels of the port (mirrors `repro.kernels`): the hand-written Hopper
MTTKRP and TTMc kernels, their build, their plain PyTorch versions, and the
planned workspaces that drive them."""
