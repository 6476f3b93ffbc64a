"""Where the port runs: on the card unless the caller names a device.

Every public entry point that creates tensors takes `device=None` and
resolves it here, so no helper quietly runs on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for another device;
    no GPU means an error, never a quiet CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' explicitly "
                               "to run the plain PyTorch path")
        device = "cuda"
    return torch.device(device)
