"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises where a CUDA device is asked for
    and CUDA is absent (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for, but CUDA is not available; "
                           "pass device='cpu' to run on the host")
    return device
