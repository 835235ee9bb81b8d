"""Received-pulse re-simulation of the window assembly on the reference's
quantized range grid (counterpart of `lidar_snow_sim_tpu/ops/waveform.py`).

Every bump (an occluding flake, or the partly occluded hard target)
deposits a sin^2 pulse over the grid bins within one pulse width c*tau_h of
its range (simulation.py:137-149,547-551); the augmented return is the
first bin of the summed waveform's peak (simulation.py:151-156). Each bump
is evaluated over the whole grid with an integer-bin window mask, and
sin^2(pi (R - r)/ctau) = (1 - cos(2 pi (R - r)/ctau))/2 by the
angle-addition identity from the grid's precomputed cos/sin tables. The
caller computes the amplitudes (0.9 * max_intensity * ratio * xsi(r) / r^2).
"""

from __future__ import annotations

import math

import torch

from lidar_snow_sim_tpu_torch.config import SPEED_OF_LIGHT
from lidar_snow_sim_tpu_torch.ops.f32 import div


def xsi(r, r1: float = 0.9, r2: float = 1.0):
    """Transmitter/receiver overlap ramp (simulation.py:553-569)."""
    return torch.clamp(div(r - r1, r2 - r1), 0.0, 1.0)


def waveform_peak(bump_r, bump_amp, range_grid, intervals_per_meter: int = 10,
                  tau_h: float = 1e-8):
    """Sum the bumps' waveforms of P beams and locate each peak.

    Args:
      bump_r, bump_amp: (P, B) bump start ranges (m) and amplitudes (an
        unused bump has amplitude 0)
      range_grid: (M,) the quantized grid R (SnowfallConfig.range_grid)

    Returns (peak value (P,), first peak bin (P,) int64): ties go to the
    lowest bin, as np.argmax's.
    """
    m = range_grid.shape[0]
    c_tau = SPEED_OF_LIGHT * tau_h
    phase = 2.0 * math.pi / c_tau
    bins = torch.arange(m, device=range_grid.device)
    binf = bins.to(torch.float32)
    gphase = phase * range_grid
    cos_g, sin_g = torch.cos(gphase), torch.sin(gphase)

    wave = torch.zeros((bump_r.shape[0], m), device=range_grid.device)
    for b in range(bump_r.shape[1]):
        r = bump_r[:, b:b + 1]
        window = (binf >= r * intervals_per_meter) & (
            binf <= (r + c_tau) * intervals_per_meter)
        beta = phase * r
        pulse = 0.5 * (1.0 - (cos_g * torch.cos(beta)
                              + sin_g * torch.sin(beta)))
        wave = wave + torch.where(window, bump_amp[:, b:b + 1] * pulse, 0.0)
    peak = wave.amax(dim=1)
    idx = torch.where(wave == peak[:, None], bins, m).amin(dim=1)
    return peak, idx
