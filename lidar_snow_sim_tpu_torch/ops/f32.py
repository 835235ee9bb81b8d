"""float32 arithmetic that rounds the same on every device.

PyTorch's CUDA division by a Python (CPU) scalar multiplies by the
reciprocal, which can differ from the correctly rounded quotient by one
ulp; the CPU backend, XLA and the port's CUDA kernels divide. Dividing by
a 0-dim tensor on the operand's device keeps the true division everywhere.
"""

from __future__ import annotations

import torch


def div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b correctly rounded in a's dtype, on any device; b is a tensor
    or a Python number."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b
