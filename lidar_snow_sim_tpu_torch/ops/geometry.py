"""Beam geometry on tensors (counterpart of `lidar_snow_sim_tpu/ops/geometry.py`).

Angles follow the reference convention: wrapped into [0, 2pi), and a beam
wedge [right, left] has right > left iff it crosses the 0/2pi seam.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def wrap_02pi(a: torch.Tensor) -> torch.Tensor:
    """Wrap angles into [0, 2pi) with a single add or subtract (valid for
    inputs in (-2pi, 4pi)), as the reference does."""
    a = torch.where(a < 0, a + TWO_PI, a)
    return torch.where(a > TWO_PI, a - TWO_PI, a)


def beam_limits(x: torch.Tensor, y: torch.Tensor, beam_divergence_rad: float):
    """Wrapped beam wedge (right, left) around each point's azimuth
    (simulation.py:91-101)."""
    center = wrap_02pi(torch.atan2(y, x))
    right = wrap_02pi(center - beam_divergence_rad / 2)
    left = wrap_02pi(center + beam_divergence_rad / 2)
    return right, left


def norm3(xyz: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3, as
    sqrt(x * x + y * y + z * z) in that order on every device."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.sqrt(x * x + y * y + z * z)
