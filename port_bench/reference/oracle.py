"""Snowfall semantics of one scan in float64 NumPy: a frozen copy of the
port's oracle (`lidar_snow_sim_tpu_torch/oracle/snowfall.py`), which
follows the reference pipeline (SysCV/LiDAR_snow_sim
`tools/snowfall/simulation.py` and `geometry.py`), quirks included:

- the occlusion dict of a beam holds its particles by ascending range,
  then the hard target under key -1; in the pulse loop the amplitude scale
  is overwritten by the snowflake's (0.9 * max_intensity / beta_0) on
  every particle key and not restored for key -1 (simulation.py:137-141);
- new intensities truncate toward zero (int(i_max), simulation.py:162);
- a particle enters the dict iff it claims at least one elementary angular
  interval not claimed by a nearer particle (simulation.py:282-290);
- beams across the 0/2pi seam are unwrapped (simulation.py:259-263).

One change from the copy, which leaves every result bit for bit as it was:
`occlusion_dicts` hands `_beam_intervals` only the in-range particles that
lie within the beam's half-width plus the particle's own angular
half-width of the beam (`_candidates`), in their original order, where the
copy handed it every in-range particle. A particle outside that band
passes none of the intersection tests (its edge distance exceeds its
radius), so the intersecting set, its order and every value computed from
it are those of the copy; port_bench/tests/test_port_bench_reference.py
holds the two equal. It makes a 50k-point scan take seconds, not minutes.

`rnd`, where given, rounds the geometry (points, particles, beam angles,
ranges) to a lower precision: the control of the comparison.
"""

from __future__ import annotations

import numpy as np

PI = np.pi
TWO_PI = 2 * np.pi
SPEED_OF_LIGHT = 299792458.0
# particles of a larger angular half-width are candidates of every beam
_WIDE_HALFWIDTH = 0.02
_BAND_SLACK = 1e-9   # rad, over the exact band: rounding of the tests


def _wrap_02pi(a):
    a = np.asarray(a, dtype=np.float64).copy()
    a[a < 0] += TWO_PI
    a[a > TWO_PI] -= TWO_PI
    return a


def _edge_line_coeffs(angles):
    vertical = (angles == PI / 2) | (angles == 3 * PI / 2)
    a = np.where(vertical, 1.0, -np.tan(angles))
    b = np.where(vertical, 0.0, 1.0)
    return a, b


def _ray_hits_center_halfplane(angle, pang):
    d = angle - pang
    return ((np.abs(d) < PI / 2) | (np.abs(d - TWO_PI) < PI / 2)
            | (np.abs(d + TWO_PI) < PI / 2))


def _tangent_angles(particles, pang):
    x, y, r = particles[:, 0], particles[:, 1], particles[:, 2]
    disc = r * np.sqrt(x ** 2 + y ** 2 - r ** 2)
    vertical_case = np.abs(x) - r == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        a1 = np.where(vertical_case, 1.0, (-x * y + disc) / (r ** 2 - x ** 2))
        a2 = np.where(vertical_case, (y ** 2 - x ** 2) / (2 * x * y),
                      (-x * y - disc) / (r ** 2 - x ** 2))
    b1 = np.where(vertical_case, 0.0, -1.0)
    b2 = -np.ones_like(a2)
    out = np.empty((len(x), 2))
    for i, (a, b) in enumerate(((a1, b1), (a2, b2))):
        with np.errstate(divide="ignore", invalid="ignore"):
            ray1 = np.arctan(-a / b)
        ray2 = ray1 + PI
        ray1 = np.where(ray1 < 0, ray1 + TWO_PI, ray1)
        ray1 = np.abs(ray1)
        ray1 = np.where(b == 0, PI / 2, ray1)
        ray2 = np.where(b == 0, 3 * PI / 2, ray2)
        for cand in (ray1, ray2):
            diff = cand - pang
            ok = ((np.abs(diff) < PI / 2) | (np.abs(diff - TWO_PI) < PI / 2)
                  | (np.abs(diff + TWO_PI) < PI / 2))
            out[ok, i] = cand[ok]
    out.sort(axis=1)
    swap = out[:, 1] - out[:, 0] > PI
    out[swap] = out[swap][:, ::-1]
    return out


def _beam_intervals(particles, right_angle, left_angle):
    """(L, 3) [a_right, a_left, distance] of the particles that intersect
    the beam, by ascending distance (simulation.py:345-417)."""
    if len(particles) == 0:
        return np.zeros((0, 3))
    x, y, r = particles[:, 0], particles[:, 1], particles[:, 2]
    pang = _wrap_02pi(np.arctan2(y, x))
    dist = np.hypot(x, y)
    wrapped_beam = right_angle > left_angle
    center_in = (right_angle <= pang) & (pang <= left_angle)
    if wrapped_beam:
        center_in |= (right_angle - TWO_PI <= pang) & (pang <= left_angle)
        center_in |= (right_angle <= pang) & (pang <= left_angle + TWO_PI)
    ar, br = _edge_line_coeffs(np.array([right_angle]))
    al, bl = _edge_line_coeffs(np.array([left_angle]))
    dist_r = np.abs(ar[0] * x + br[0] * y) / np.hypot(ar[0], br[0])
    dist_l = np.abs(al[0] * x + bl[0] * y) / np.hypot(al[0], bl[0])
    right_hit = (dist_r < r) & _ray_hits_center_halfplane(right_angle, pang)
    left_hit = (dist_l < r) & _ray_hits_center_halfplane(left_angle, pang)
    intersect = center_in | right_hit | left_hit
    if not np.any(intersect):
        return np.zeros((0, 3))
    p = particles[intersect]
    tang = _tangent_angles(p, pang[intersect])
    tang[right_hit[intersect], 0] = right_angle
    tang[left_hit[intersect], 1] = left_angle
    intervals = np.column_stack([tang, dist[intersect]])
    return intervals[np.argsort(intervals[:, 2], kind="stable")]


def occlusion_dict_for_beam(right_angle, left_angle, intervals,
                            current_range, beam_divergence_deg):
    """First-claim angular sweep (simulation.py:231-295): {position in the
    distance-sorted intervals: (range, ratio)}, -1 the unoccluded rest."""
    beam_rad = np.radians(beam_divergence_deg)
    intervals = intervals.copy()
    if right_angle > left_angle:
        right_angle = right_angle - TWO_PI
        viol = intervals[:, 0] > intervals[:, 1]
        intervals[viol, 0] -= TWO_PI
    endpoints = np.array(sorted(set(
        [right_angle, left_angle] + list(intervals[:, :2].ravel()))))
    diffs = np.diff(endpoints)
    assignment = -np.ones(len(diffs), dtype=np.int64)
    out = {}
    for j in range(len(intervals)):
        a1, a2, dist = intervals[j]
        i1 = int(np.searchsorted(endpoints, a1))
        i2 = int(np.searchsorted(endpoints, a2))
        claim = assignment[i1:i2] == -1
        if np.any(claim):
            assignment[i1:i2][claim] = j
            ratio = diffs[assignment == j].sum() / beam_rad
            out[j] = (dist, float(np.clip(ratio, 0, 1)))
    remainder = diffs[assignment == -1].sum() / beam_rad
    out[-1] = (float(current_range), float(np.clip(remainder, 0, 1)))
    return out


class _Candidates:
    """The particles of one set sorted by azimuth, to find those within
    an angular band of a beam: every particle whose angular half-width
    asin(r / d) is below _WIDE_HALFWIDTH lies in the band of azimuths
    [right - H, left + H], H the largest such half-width; the others are
    candidates of every beam."""

    def __init__(self, particles):
        x, y, r = particles[:, 0], particles[:, 1], particles[:, 2]
        self.ranges = np.hypot(x, y)
        halfwidth = np.arcsin(np.clip(r / np.maximum(self.ranges, 1e-300),
                                      0.0, 1.0))
        narrow = halfwidth < _WIDE_HALFWIDTH
        self.wide = np.nonzero(~narrow)[0]
        idx = np.nonzero(narrow)[0]
        pang = _wrap_02pi(np.arctan2(y, x))[idx]
        srt = np.argsort(pang, kind="stable")
        # the sorted azimuths with their copies one turn down and up
        self.ang = np.concatenate([pang[srt] - TWO_PI, pang[srt],
                                   pang[srt] + TWO_PI])
        self.idx = np.tile(idx[srt], 3)
        self.reach = (halfwidth[narrow].max() if narrow.any() else 0.0
                      ) + _BAND_SLACK

    def __call__(self, right_angle, left_angle, current_range):
        """Sorted indices of the in-range candidates of the beam."""
        left = left_angle + TWO_PI if right_angle > left_angle else left_angle
        lo = np.searchsorted(self.ang, right_angle - self.reach, "left")
        hi = np.searchsorted(self.ang, left + self.reach, "right")
        cand = np.union1d(self.idx[lo:hi], self.wide)
        return cand[self.ranges[cand] < current_range]


def occlusion_dicts(beam_angles, ranges_orig, particles, beam_divergence_deg):
    """Per-beam occlusion dicts against a particle set
    (simulation.py:298-424)."""
    find = _Candidates(particles)
    out = []
    for i in range(beam_angles.shape[0]):
        right, left = beam_angles[i, 0], beam_angles[i, 1]
        intervals = _beam_intervals(
            particles[find(right, left, ranges_orig[i])], right, left)
        out.append(occlusion_dict_for_beam(right, left, intervals,
                                           ranges_orig[i],
                                           beam_divergence_deg))
    return out


def _xsi(r, r1=0.9, r2=1.0):
    if r <= r1:
        return 0.0
    if r >= r2:
        return 1.0
    return (r - r1) / (r2 - r1)


def resimulate_channel(pc, occlusion_list, channel, min_intensity,
                       focal_distance, focal_slope):
    """Re-simulate the received pulse of every point of one channel
    (simulation.py:50-194): (intensity difference sum, modified rows); a
    point's label becomes 0 (no particle), 1 (attenuated in place) or 2
    (moved to the snowflake's range)."""
    pc = pc.copy()
    distance = np.linalg.norm(pc[:, :3], axis=1)
    lidar_range, ipm = 120, 10
    beta_0 = 1e-6 / PI
    tau_h = 1e-8
    c = SPEED_OF_LIGHT
    m_ext = int(np.ceil(lidar_range * ipm + c * tau_h * ipm))
    grid = np.round(np.linspace(0, lidar_range + c * tau_h, m_ext), 2)
    focal_offset = (1 - focal_distance / 13100) ** 2
    max_intensity = 230.0 if channel in (53, 55, 56, 58) else 255.0
    intensity_diff_sum = 0.0
    for j, beam_dict in enumerate(occlusion_list):
        d_orig = distance[j]
        i_orig = pc[j, 3]
        i_adjusted = i_orig - 255 * focal_slope * np.abs(
            focal_offset - (1 - d_orig / 120) ** 2)
        i_adjusted = np.clip(i_adjusted, 0, max_intensity)
        ca_p0 = i_adjusted * d_orig ** 2 / beta_0
        if len(beam_dict) <= 1:
            pc[j, 4] = 0
            continue
        wave = np.zeros(m_ext)
        for key, (r_j, ratio) in beam_dict.items():
            if key != -1:
                i_orig = 0.9 * max_intensity
                ca_p0 = i_orig / beta_0
            start = int(np.ceil(r_j * ipm))
            end = int(np.floor((r_j + c * tau_h) * ipm) + 1)
            amp = ca_p0 * beta_0 * ratio * _xsi(r_j) / r_j ** 2
            for k in range(start, min(end, m_ext)):
                wave[k] += amp * np.sin(PI * (grid[k] - r_j) / (c * tau_h)) ** 2
        max_idx = int(np.argmax(wave))
        i_max = wave[max_idx]
        d_max = max_idx / ipm - c * tau_h / 2
        i_max += max_intensity * focal_slope * np.abs(
            focal_offset - (1 - d_max / 120) ** 2)
        i_max = np.clip(i_max, min_intensity, max_intensity)
        if abs(d_max - d_orig) < 2 / ipm:
            pc[j, 4] = 1
            new_i = int(i_max)
            intensity_diff_sum += i_orig - new_i
        else:
            pc[j, 4] = 2
            scale = d_max / d_orig
            pc[j, 0] *= scale
            pc[j, 1] *= scale
            pc[j, 2] *= scale
            new_i = int(i_max)
        pc[j, 3] = np.clip(new_i, min_intensity, max_intensity)
    return intensity_diff_sum, pc


def snow_channels(pc, particle_sets, calib, order, beam_divergence_deg,
                  rnd=None, channels=None):
    """The channels `channels` (default: all) of a channel-sorted scan `pc`
    (float64 rows), each against its particle set
    `particle_sets[order[channel]]`: (intensity difference sum, the rows
    of those channels as `resimulate_channel` gives them, intensities not
    yet rounded). `particle_sets` may be a dict holding only the sets
    those channels read."""
    mask_all = np.isin(pc[:, 4], np.arange(calib.num_lasers)
                       if channels is None else np.asarray(channels))
    aug = pc[mask_all].copy()
    sub = pc[mask_all]
    diff_sum = 0.0
    beam_rad = np.radians(beam_divergence_deg)
    for channel in np.unique(sub[:, 4]).astype(np.int64):
        mask = sub[:, 4] == channel
        cpc = sub[mask]
        d = np.linalg.norm(cpc[:, :3], axis=1)
        center = _wrap_02pi(np.arctan2(cpc[:, 1], cpc[:, 0]))
        beams = _wrap_02pi(np.column_stack([center - beam_rad / 2,
                                            center + beam_rad / 2]))
        sets = np.asarray(particle_sets[order[channel]], np.float64)
        if rnd is not None:
            d, beams, sets = rnd(d), rnd(beams), rnd(sets)
        occl = occlusion_dicts(beams, d, sets, beam_divergence_deg)
        ds, new_cpc = resimulate_channel(
            cpc, occl, int(channel), float(calib.min_intensity[channel]),
            float(calib.focal_distance[channel]),
            float(calib.focal_slope[channel]))
        diff_sum += ds
        aug[mask] = new_cpc
    return diff_sum, aug
