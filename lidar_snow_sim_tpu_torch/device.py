"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device. Entry points default to the card; asked
    for a CUDA device where there is none, this raises rather than running
    on the CPU, which must be asked for (device="cpu", --device cpu)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev
