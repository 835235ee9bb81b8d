"""First-claim angular sweep of the window assembly as a sort and a
reduction (counterpart of `lidar_snow_sim_tpu/ops/sweep.py`).

A sub-interval between two sorted endpoint angles goes to the nearest
occluder covering it (the reference claims in ascending range,
simulation.py:231-295), so for each beam:

  endpoints  = sort([right', left] ++ starts ++ ends)         (2K+2,)
  midpoints  = (endpoints[:-1] + endpoints[1:]) / 2            (2K+1,)
  cover[j,k] = start_j <= mid_k <= end_j                       (K, 2K+1)
  winner_k   = min_j (cover ? j : inf)                         (2K+1,)
  claimed_j  = sum_k diffs_k * [winner_k == j]

Duplicate endpoints make zero-width sub-intervals that claim nothing. A beam
crossing 0/2pi is unwrapped as the reference does. Each occluder's widths,
and the target's, are summed in interval order (ascending endpoints): the
order of kernel W2 (`ops/pulse.window_pulse_peaks`), which equals this
function bit for bit, and of the dense assembly's phase C, which computes
the same claims by extract-min (`ops/pulse.py`).
"""

from __future__ import annotations

import torch

from lidar_snow_sim_tpu_torch.ops.f32 import div
from lidar_snow_sim_tpu_torch.ops.geometry import TWO_PI

_BIG = 3.0e38


def occlusion_sweep(right, left, a1, a2, valid, beam_divergence_rad: float):
    """Resolve the interval claims of P beams.

    Args:
      right, left: (P,) wrapped beam limits
      a1, a2: (P, K) occlusion intervals, each row sorted by ascending
        particle range (claim priority = column order)
      valid: (P, K) occluder mask

    Returns ratio (P, K), the claimed angle over the beam divergence in
    [0, 1]; remainder (P,), the unclaimed share (the hard target's); and
    touched (P, K), whether the occluder claimed a sub-interval of positive
    width (the reference's assignment_made).
    """
    k = a1.shape[1]
    wrapped = right > left
    right = torch.where(wrapped, right - TWO_PI, right)
    a1 = torch.where(wrapped[:, None] & (a1 > a2), a1 - TWO_PI, a1)
    # invalid occluders collapse to a zero-width interval at the left limit
    a1 = torch.where(valid, a1, left[:, None])
    a2 = torch.where(valid, a2, left[:, None])

    endpoints = torch.sort(
        torch.cat([right[:, None], left[:, None], a1, a2], dim=1), dim=1
    ).values
    diffs = endpoints[:, 1:] - endpoints[:, :-1]             # (P, 2K+1)
    mids = (endpoints[:, :-1] + endpoints[:, 1:]) * 0.5

    cover = ((a1[:, :, None] <= mids[:, None, :])
             & (mids[:, None, :] <= a2[:, :, None])
             & valid[:, :, None])                            # (P, K, 2K+1)
    ranks = torch.arange(k, dtype=torch.float32, device=a1.device)
    winner = torch.where(cover, ranks[:, None], _BIG).amin(dim=1)
    claimed = torch.zeros_like(a1)                           # (P, K)
    unclaimed = torch.zeros_like(left)
    for i in range(diffs.shape[1]):   # in interval order, as kernel W2
        w, d = winner[:, i], diffs[:, i]
        claimed = claimed + torch.where(ranks == w[:, None], d[:, None], 0.0)
        unclaimed = unclaimed + torch.where(w == _BIG, d, 0.0)

    ratio = torch.clamp(div(claimed, beam_divergence_rad), 0.0, 1.0)
    remainder = torch.clamp(div(unclaimed, beam_divergence_rad), 0.0, 1.0)
    return ratio, remainder, claimed > 0.0
