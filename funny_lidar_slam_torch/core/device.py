"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: `None`
means CUDA, and a missing CUDA runtime is an error rather than a silent
CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
