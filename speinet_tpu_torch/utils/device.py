"""The port's device rule: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device to run on; CUDA unless the caller asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev
