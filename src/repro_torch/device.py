"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else CUDA.

    Raises when no device was given and no GPU is present — the port never
    drops to the CPU silently; pass `device="cpu"` to ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # compare equal to tensor.device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
