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


def _point_line_distance(px, py, theta):
    """Distance of (px, py) to the line through the origin at angle theta."""
    return torch.abs(px * torch.sin(theta) - py * torch.cos(theta))


def _same_halfplane(theta, pang):
    """Whether the ray at theta (not its opposite) points toward pang."""
    return torch.cos(theta - pang) > 0


def candidate_angles(px, py, pr, pdist):
    """(pang, start, end) of candidates: the center azimuth and the tangent
    rays pang -+ asin(r/d), each wrapped into [0, 2pi). They depend on the
    candidate alone, so the window assembly reads them from per-column
    tables that this function makes once a bank (ops/occluders.
    window_angles)."""
    pang = wrap_02pi(torch.atan2(py, px))
    delta = torch.arcsin(torch.clamp(pr / pdist.clamp_min(1e-12), 0.0, 1.0))
    return pang, wrap_02pi(pang - delta), wrap_02pi(pang + delta)


def candidate_intervals(right, left, px, py, pr, pdist, pvalid,
                        current_range, angles=None):
    """Intersection test and clipped occlusion intervals of P beams against
    their C candidates each (the window assembly's, geometry.py:14-29 and
    simulation.py:356-390).

    Args:
      right, left, current_range: (P,) wrapped beam limits and the hard
        target's range
      px, py, pr, pdist, pvalid: (P, C) candidate center, radius, range and
        validity
      angles: the candidates' (pang, start, end), each (P, C), where they
        were made before (`candidate_angles`); None computes them here

    Returns (a1, a2, intersects), each (P, C): the occlusion interval in
    the wrapped convention (start > end iff it crosses 0/2pi), and whether
    the particle intersects the beam, is closer than the target and valid.
    A disk intersects the wedge iff its center lies inside, or it overlaps
    an edge ray (center-to-line distance below r, center in the ray's
    half-plane); its interval is the tangent rays center +- asin(r/d),
    clipped to the edge it overlaps.
    """
    right, left = right[:, None], left[:, None]
    pang, start, end = (candidate_angles(px, py, pr, pdist)
                        if angles is None else angles)
    wrapped_beam = right > left

    center_in = (right <= pang) & (pang <= left)
    center_in |= wrapped_beam & (right - TWO_PI <= pang) & (pang <= left)
    center_in |= wrapped_beam & (right <= pang) & (pang <= left + TWO_PI)

    right_hit = (_point_line_distance(px, py, right) < pr) & \
        _same_halfplane(right, pang)
    left_hit = (_point_line_distance(px, py, left) < pr) & \
        _same_halfplane(left, pang)

    in_range = pdist < current_range[:, None]
    intersects = (center_in | right_hit | left_hit) & in_range & pvalid

    a1 = torch.where(right_hit, right, start)
    a2 = torch.where(left_hit, left, end)
    return a1, a2, intersects
