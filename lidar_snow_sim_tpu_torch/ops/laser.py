"""Laser output power and adaptive noise floor on tensors (counterpart of
`lidar_snow_sim_tpu/ops/laser.py`; reference
`tools/wet_ground/augmentation.py:195-266`).

The noise floor comes from a (50 x 2555) histogram of (distance,
normalized intensity): per distance row, the intensity bin with the fewest
points (empty bins pre-filled with the point count), rows above 5 fitted
linearly and scaled by `noise_floor`. The histogram is counted as run
lengths of the sorted bin ids; ties in a row go to the lowest bin.
"""

from __future__ import annotations

import torch

from lidar_snow_sim_tpu_torch.ops.fitting import (
    masked_linregress,
    masked_polyfit2,
    polyval2,
)
from lidar_snow_sim_tpu_torch.ops.f32 import div
from lidar_snow_sim_tpu_torch.ops.geometry import norm3

_X_BINS = 50
_Y_BINS = 2555
_D_LO, _D_HI = 10.0, 70.0
_Y_LO = 5.0
_I32_MAX = 2**31 - 1


def _bin_index(v, lo, hi, nbins):
    """np.histogram2d bin index: [lo, hi) uniform bins, hi inclusive in the
    last bin; returns (idx, in_range)."""
    scaled = div(v - lo, hi - lo) * nbins
    idx = torch.floor(scaled).to(torch.int64)
    idx = torch.where(v == hi, nbins - 1, idx)
    in_range = (v >= lo) & (v <= hi)
    return idx.clamp(0, nbins - 1), in_range


def noise_floor_rows(distance, norm_int, mask):
    """Per-distance-row minimal-count intensity estimate.

    Returns (x_centers (50,), min_vals (50,), row_valid (50,)), where
    row_valid applies the reference's min_vals > 5 filter.
    """
    n_points = mask.sum()
    y_hi = torch.where(mask, norm_int, -float("inf")).max().abs()

    xi, x_ok = _bin_index(distance, _D_LO, _D_HI, _X_BINS)
    yi, y_ok = _bin_index(norm_int, _Y_LO, y_hi, _Y_BINS)
    ok = mask & x_ok & y_ok

    sentinel = _X_BINS * _Y_BINS
    s = torch.sort(torch.where(ok, xi * _Y_BINS + yi, sentinel)).values
    n = s.shape[0]
    iota = torch.arange(n, device=s.device)
    is_start = torch.ones(n, dtype=torch.bool, device=s.device)
    is_start[1:] = s[1:] != s[:-1]
    start_pos = torch.where(is_start, iota, n)
    suf_min = torch.flip(torch.cummin(torch.flip(start_pos, [0]), 0).values, [0])
    nxt = torch.cat([suf_min[1:], torch.full((1,), n, device=s.device)])
    cnt = nxt - iota                   # run length, valid at run starts
    valid = is_start & (s < sentinel)
    row_of = s // _Y_BINS
    ybin_of = s % _Y_BINS
    rows = torch.arange(_X_BINS, device=s.device)
    in_row = (row_of[None, :] == rows[:, None]) & valid[None, :]   # (50, n)
    cnt_b = cnt[None, :].expand(in_row.shape)
    cmin = torch.where(in_row, cnt_b, _I32_MAX).min(dim=1).values
    ymin_at_cmin = torch.where(
        in_row & (cnt_b == cmin[:, None]), ybin_of[None, :], _I32_MAX
    ).min(dim=1).values
    # an empty row, or a minimum count tying the n_points fill, lands on
    # the first (filled) bin
    ymins = torch.where(
        (cmin == _I32_MAX) | (cmin >= n_points), 0, ymin_at_cmin
    )

    yedge = _Y_LO + div(ymins.to(torch.float32) * (y_hi - _Y_LO), _Y_BINS)
    xedges = torch.linspace(_D_LO, _D_HI, _X_BINS + 1, device=s.device)
    x_centers = (xedges[:-1] + xedges[1:]) * 0.5
    return x_centers, yedge, yedge > _Y_LO


def estimate_laser_parameters(
    ground_xyz,
    ground_intensity,
    incident_angle,
    mask,
    power_factor: float = 15.0,
    noise_floor: float = 0.7,
    estimation_method: str = "linear",
):
    """Relative output power and adaptive noise threshold at every point
    (meaningful where `mask` marks a ground point)."""
    norm_int = ground_intensity / torch.cos(incident_angle)
    distance = norm3(ground_xyz)

    if estimation_method == "linear":
        slope, intercept = masked_linregress(distance, norm_int, mask)
        p_power = torch.stack([torch.zeros_like(slope), slope, intercept])
    elif estimation_method == "poly":
        p_power = masked_polyfit2(distance, norm_int, mask)
    else:
        raise ValueError(estimation_method)
    relative_output = power_factor * polyval2(p_power, distance)

    x, min_vals, row_ok = noise_floor_rows(distance, norm_int, mask)
    if estimation_method == "poly":
        p_rows = masked_polyfit2(x, min_vals, row_ok)
    else:
        s, i = masked_linregress(x, min_vals, row_ok)
        p_rows = torch.stack([torch.zeros_like(s), s, i])
    # reference fallback: reuse the power fit when <= 3 rows are usable
    p_min = torch.where(row_ok.sum() > 3, p_rows, p_power)

    threshold = noise_floor * polyval2(p_min, distance)
    return relative_output, threshold
