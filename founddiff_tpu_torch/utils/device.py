"""Where the port's entry points run: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; CUDA asked for on a host without a
    card raises rather than running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA device requested but no GPU is available; "
                           "pass device='cpu' to run the plain versions")
    return device
