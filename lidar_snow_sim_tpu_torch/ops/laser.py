"""Laser output power and adaptive noise floor on tensors (counterpart of
`lidar_snow_sim_tpu/ops/laser.py`; reference
`tools/wet_ground/augmentation.py:195-266`).

The noise floor comes from a (50 x 2555) histogram of (distance,
normalized intensity): per distance row, the intensity bin with the fewest
points (empty bins pre-filled with the point count), rows above 5 fitted
linearly and scaled by `noise_floor`. The histogram is counted as run
lengths of the sorted bin ids; ties in a row go to the lowest bin.

`noise_floor_at` is the snowfall path's use of it: the noise threshold's
degree-2 fit over range at every point, for a given ground plane. On CUDA
tensors it runs as kernel P2 (`csrc/preamble.cu`, one launch, no host
sync), on CPU tensors as `noise_floor_at_plain`.
"""

from __future__ import annotations

import functools

import torch

from lidar_snow_sim_tpu_torch import _kernels
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
    ymins, y_hi = noise_floor_bins(distance, norm_int, mask)
    yedge = _Y_LO + div(ymins.to(torch.float32) * (y_hi - _Y_LO), _Y_BINS)
    return _row_centers(ymins.device), yedge, yedge > _Y_LO


def _row_centers(device) -> torch.Tensor:
    """The 50 distance rows' centres, made on `device`."""
    xedges = torch.linspace(_D_LO, _D_HI, _X_BINS + 1, device=device)
    return (xedges[:-1] + xedges[1:]) * 0.5


def noise_floor_bins(distance, norm_int, mask):
    """Each distance row's intensity bin of fewest points (50,) int64 and
    the histogram's top edge y_hi: the steps of `noise_floor_rows` that
    kernel P2 matches exactly."""
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
    return ymins, y_hi


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


def noise_floor_at(xyz, intensity, mask, dist, plane, cfg):
    """The adaptive noise threshold at every point's range
    (simulation.py:449-469): the ground band |w.p + h| < cfg.ground_delta
    of the plane `plane` = (w (3,), h), its intensities normalized by the
    cosine of their incidence, `estimate_laser_parameters`' linear
    threshold (scaled by cfg.noise_floor) times that cosine, fitted by a
    degree-2 polynomial over `dist` and evaluated there. Kernel P2 on CUDA
    tensors (`noise_floor_p2`), `noise_floor_at_plain` on CPU tensors."""
    if xyz.device.type == "cpu":
        return noise_floor_at_plain(xyz, intensity, mask, dist, plane, cfg)
    w, h = plane
    return noise_floor_p2(xyz, intensity, mask.contiguous(),
                          dist.contiguous(),
                          (w.contiguous(), h.contiguous()), cfg)[0]


noise_floor_at.launches = 0


def noise_floor_at_plain(xyz, intensity, mask, dist, plane, cfg):
    """Plain torch version of kernel P2: `noise_floor_at` on any device."""
    ground, incident = ground_and_incidence(xyz, mask, dist, plane,
                                            cfg.ground_delta)
    _, threshold = estimate_laser_parameters(
        xyz, intensity, incident, ground, noise_floor=cfg.noise_floor
    )
    threshold = threshold * torch.cos(incident)
    noise_poly = masked_polyfit2(dist, threshold, ground)
    return polyval2(noise_poly, dist)


def ground_and_incidence(xyz, mask, dist, plane, ground_delta: float):
    """The ground band |w.p + h| < ground_delta of the masked points (N,)
    bool and every point's incidence angle on the plane (w, h) (N,): the
    plain version's first step, which kernel P2 matches exactly."""
    w, h = plane
    hog = xyz @ w + h
    ground = mask & (hog < ground_delta) & (hog > -ground_delta)
    incident = torch.arccos(torch.clamp(
        (xyz @ w) / (dist.clamp_min(1e-12) * torch.linalg.vector_norm(w)),
        -1, 1,
    ))
    return ground, incident


# kernel P2's row centres, made once a device as `noise_floor_rows` makes
# them there
_x_centers = functools.cache(_row_centers)


def noise_floor_p2(xyz, intensity, mask, dist, plane, cfg):
    """Kernel P2 (`csrc/preamble.cu`) on CUDA tensors: xyz (N, 3) and
    intensity (N,) f32 at any strides (column views of the points, or of
    their planes), mask (N,) bool, dist (N,) f32, plane (w (3,), h (1,) or ())
    f32 on the device. Returns (noise_at (N,), stats (110,) f32: ground
    points, y_hi, the power fit's slope and intercept, the row fit's and
    its usable rows, the noise polynomial (p2, p1, p0), each row's
    least-count bin, each row's edge; ground (N,) int32, the ground band),
    on the device; the host reads nothing."""
    n = xyz.shape[0]
    if n < 1:
        raise ValueError("noise_floor_at: kernel P2 takes >= 1 point")
    w, h = plane
    rs, cs = _kernels.check_layout("xyz", xyz, torch.float32, (n, 3),
                                   strided=True)
    (int_stride,) = _kernels.check_layout("intensity", intensity,
                                          torch.float32, (n,), strided=True)
    _kernels.check_layout("mask", mask, torch.bool, (n,))
    _kernels.check_layout("dist", dist, torch.float32, (n,))
    _kernels.check_layout("w", w, torch.float32, (3,))
    if h.numel() != 1:
        raise ValueError(f"h: shape {tuple(h.shape)}, need one value")
    _kernels.check_layout("h", h, torch.float32, h.shape)
    dev = _kernels.check_cuda(xyz=xyz, intensity=intensity, mask=mask,
                              dist=dist, w=w, h=h)
    scratch = torch.empty(4 * n + _X_BINS * _Y_BINS, dtype=torch.int32,
                          device=dev)
    stats = torch.empty(10 + 2 * _X_BINS, dtype=torch.float32, device=dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    err = _kernels.launch(
        dev, _kernels.load("preamble").preamble_p2,
        xyz.data_ptr(), rs, cs, intensity.data_ptr(), int_stride,
        mask.data_ptr(), dist.data_ptr(), w.data_ptr(), h.data_ptr(),
        _x_centers(dev).data_ptr(), n, cfg.ground_delta, cfg.noise_floor,
        scratch.data_ptr(), stats.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(err, "kernel P2 (preamble_p2)")
    noise_floor_at.launches += 1
    return out, stats, scratch[3 * n:4 * n]
