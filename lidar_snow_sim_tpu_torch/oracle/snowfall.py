"""Literal-semantics snowfall augmentation oracle (host NumPy).

Reproduces the observable behavior of the reference pipeline
(`tools/snowfall/simulation.py` + `tools/snowfall/geometry.py`) including its
quirks, which are load-bearing for output parity:

- Dict insertion order in the occlusion dict is (particles by ascending range,
  then the hard target under key -1); in the pulse loop the amplitude scale
  CA_P0 is overwritten by the *snowflake* value (0.9 * max_intensity / beta_0)
  on every particle key and NOT restored for key -1 (simulation.py:137-141).
  Net effect: whenever a beam contains any snowflake, every bump — including
  the hard target's — uses the snowflake amplitude, and the "original
  intensity" used for the attenuation statistics is 0.9 * max_intensity.
- new intensities truncate toward zero (int(i_max), simulation.py:162).
- A particle enters the occlusion dict iff it claims at least one elementary
  angular interval not claimed by a nearer particle (simulation.py:282-290);
  ratios are clipped to [0, 1] per key.
- Beams crossing the 0/2pi discontinuity are unwrapped by shifting the right
  limit (and any wrapped interval starts) down by 2pi (simulation.py:259-263).
"""

from __future__ import annotations

import numpy as np

from lidar_snow_sim_tpu_torch.config import SPEED_OF_LIGHT
from lidar_snow_sim_tpu_torch.oracle.fitting import (
    estimate_laser_parameters,
    polyfit2,
    ransac_plane,
)

PI = np.pi
TWO_PI = 2 * np.pi


# ----------------------------------------------------------------------------
# beam/particle geometry (semantics of tools/snowfall/geometry.py)
# ----------------------------------------------------------------------------

def _wrap_02pi(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64).copy()
    a[a < 0] += TWO_PI
    a[a > TWO_PI] -= TWO_PI
    return a


def _edge_line_coeffs(angles: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Line ax + by = 0 through the origin at direction `angles`
    (geometry.py:83-110: vertical iff angle is exactly pi/2 or 3pi/2)."""
    vertical = (angles == PI / 2) | (angles == 3 * PI / 2)
    a = np.where(vertical, 1.0, -np.tan(angles))
    b = np.where(vertical, 0.0, 1.0)
    return a, b


def _ray_hits_center_halfplane(angle: float, pang: np.ndarray) -> np.ndarray:
    """Whether the ray at `angle` (not its opposite) points toward the
    particle centers (geometry.py:193-223)."""
    d = angle - pang
    return (
        (np.abs(d) < PI / 2)
        | (np.abs(d - TWO_PI) < PI / 2)
        | (np.abs(d + TWO_PI) < PI / 2)
    )


def _tangent_angles(particles: np.ndarray, pang: np.ndarray) -> np.ndarray:
    """Tangent-ray angles of each particle disk as seen from the origin,
    via the reference's line-coefficient route (geometry.py:32-80,138-190).

    Returns (K, 2) [right, left] in [0, 2pi), swapped (right > left) when the
    interval crosses the 0/2pi discontinuity.
    """
    x, y, r = particles[:, 0], particles[:, 1], particles[:, 2]
    disc = r * np.sqrt(x**2 + y**2 - r**2)

    vertical_case = np.abs(x) - r == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        a1 = np.where(vertical_case, 1.0, (-x * y + disc) / (r**2 - x**2))
        a2 = np.where(
            vertical_case, (y**2 - x**2) / (2 * x * y), (-x * y - disc) / (r**2 - x**2)
        )
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
        # pick the ray on the particle's side
        for cand in (ray1, ray2):
            diff = cand - pang
            ok = (
                (np.abs(diff) < PI / 2)
                | (np.abs(diff - TWO_PI) < PI / 2)
                | (np.abs(diff + TWO_PI) < PI / 2)
            )
            out[ok, i] = cand[ok]

    out.sort(axis=1)
    swap = out[:, 1] - out[:, 0] > PI
    out[swap] = out[swap][:, ::-1]
    return out


def _beam_intervals(
    particles: np.ndarray,
    right_angle: float,
    left_angle: float,
) -> np.ndarray:
    """Angular occlusion intervals of the particles intersecting one beam.

    Returns (L, 3) [a_right, a_left, distance], sorted by distance ascending
    (semantics of simulation.py:345-417 for a single beam; particles must
    already be culled to range < target range).
    """
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


def occlusion_dict_for_beam(
    right_angle: float,
    left_angle: float,
    intervals: np.ndarray,
    current_range: float,
    beam_divergence_deg: float,
) -> dict:
    """First-claim angular sweep (simulation.py:231-295). Keys are positions
    in the distance-sorted interval array; -1 is the unoccluded remainder."""
    beam_rad = np.radians(beam_divergence_deg)
    intervals = intervals.copy()

    if right_angle > left_angle:
        right_angle = right_angle - TWO_PI
        viol = intervals[:, 0] > intervals[:, 1]
        intervals[viol, 0] -= TWO_PI

    endpoints = np.array(
        sorted(set([right_angle, left_angle] + list(intervals[:, :2].ravel())))
    )
    diffs = np.diff(endpoints)
    assignment = -np.ones(len(diffs), dtype=np.int64)

    out: dict[int, tuple[float, float]] = {}
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


def occlusion_dicts(
    beam_angles: np.ndarray,
    ranges_orig: np.ndarray,
    particles: np.ndarray,
    beam_divergence_deg: float,
) -> list[dict]:
    """Per-beam occlusion dicts against a particle set (simulation.py:298-424)."""
    all_ranges = np.hypot(particles[:, 0], particles[:, 1])
    out = []
    for i in range(beam_angles.shape[0]):
        in_range = particles[all_ranges < ranges_orig[i]]
        intervals = _beam_intervals(
            in_range, beam_angles[i, 0], beam_angles[i, 1]
        )
        out.append(
            occlusion_dict_for_beam(
                beam_angles[i, 0],
                beam_angles[i, 1],
                intervals,
                ranges_orig[i],
                beam_divergence_deg,
            )
        )
    return out


# ----------------------------------------------------------------------------
# pulse re-simulation (semantics of simulation.py:50-194,547-569)
# ----------------------------------------------------------------------------

def _xsi(r: float, r1: float = 0.9, r2: float = 1.0) -> float:
    if r <= r1:
        return 0.0
    if r >= r2:
        return 1.0
    return (r - r1) / (r2 - r1)


def resimulate_channel(
    pc: np.ndarray,
    occlusion_list: list[dict],
    channel: int,
    min_intensity: float,
    focal_distance: float,
    focal_slope: float,
) -> tuple[float, np.ndarray]:
    """Re-simulate the received pulse for every point of one channel.

    pc is the (N, 5) channel slice (modified copy returned); occlusion_list
    aligns with its rows. Returns (intensity_diff_sum, modified pc).
    """
    pc = pc.copy()
    distance = np.linalg.norm(pc[:, :3], axis=1)

    lidar_range = 120
    ipm = 10
    beta_0 = 1e-6 / PI
    tau_h = 1e-8
    c = SPEED_OF_LIGHT
    m_ext = int(np.ceil(lidar_range * ipm + c * tau_h * ipm))
    R = np.round(np.linspace(0, lidar_range + c * tau_h, m_ext), 2)

    focal_offset = (1 - focal_distance / 13100) ** 2
    max_intensity = 230.0 if channel in (53, 55, 56, 58) else 255.0

    intensity_diff_sum = 0.0

    for j, beam_dict in enumerate(occlusion_list):
        d_orig = distance[j]
        i_orig = pc[j, 3]

        i_adjusted = i_orig - 255 * focal_slope * np.abs(
            focal_offset - (1 - d_orig / 120) ** 2
        )
        i_adjusted = np.clip(i_adjusted, 0, max_intensity)
        ca_p0 = i_adjusted * d_orig**2 / beta_0

        if len(beam_dict) <= 1:
            pc[j, 4] = 0
            continue

        wave = np.zeros(m_ext)
        for key, (r_j, ratio) in beam_dict.items():
            if key != -1:
                # reference quirk: overwrites i_orig and ca_p0 for snowflakes
                # and never restores them before the -1 (hard target) key
                i_orig = 0.9 * max_intensity
                ca_p0 = i_orig / beta_0
            start = int(np.ceil(r_j * ipm))
            end = int(np.floor((r_j + c * tau_h) * ipm) + 1)
            amp = ca_p0 * beta_0 * ratio * _xsi(r_j) / r_j**2
            for k in range(start, min(end, m_ext)):
                wave[k] += amp * np.sin(PI * (R[k] - r_j) / (c * tau_h)) ** 2

        max_idx = int(np.argmax(wave))
        i_max = wave[max_idx]
        d_max = max_idx / ipm - c * tau_h / 2

        i_max += max_intensity * focal_slope * np.abs(
            focal_offset - (1 - d_max / 120) ** 2
        )
        i_max = np.clip(i_max, min_intensity, max_intensity)

        if abs(d_max - d_orig) < 2 / ipm:  # attenuate in place
            pc[j, 4] = 1
            new_i = int(i_max)
            intensity_diff_sum += i_orig - new_i
        else:  # point scatters to the snowflake's range
            pc[j, 4] = 2
            scale = d_max / d_orig
            pc[j, 0] *= scale
            pc[j, 1] *= scale
            pc[j, 2] *= scale
            new_i = int(i_max)

        pc[j, 3] = np.clip(new_i, min_intensity, max_intensity)

    return intensity_diff_sum, pc


def pulse_decision_margins(
    d_orig: float,
    i_orig: float,
    beam_dict: dict,
    channel: int,
    min_intensity: float,
    focal_distance: float,
    focal_slope: float,
) -> dict:
    """Distances of one point's pulse re-simulation to its f32-sensitive
    decision boundaries (same math as `resimulate_channel`; used by the
    parity tests to prove device<->oracle mismatches are boundary ties, not
    bugs — simulation.py:151-192 decision structure).

    Returned margins (all >= 0; small value == the decision sat on an edge
    where f32 and f64 can legitimately disagree):
      peak_tie      relative gap between the two largest waveform bins
                    (argmax tie, simulation.py:151)
      range_margin  | |d_max - d_orig| - 0.2 | (label 1/2 cut, :158)
      int_margin    distance of the final intensity to the nearest integer
                    (int() truncation, :162)
      bin_margin    distance of any occluder's r_j*10 (ceil edge) or
                    (r_j + c*tau_H)*10 (floor edge) to an integer (:143-147)
      min_ratio     smallest positive occlusion ratio (a ~0 claim can
                    appear/disappear under f32 sweep arithmetic, :282-290)
    """
    lidar_range, ipm = 120, 10
    beta_0 = 1e-6 / PI
    tau_h = 1e-8
    c = SPEED_OF_LIGHT
    m_ext = int(np.ceil(lidar_range * ipm + c * tau_h * ipm))
    R = np.round(np.linspace(0, lidar_range + c * tau_h, m_ext), 2)
    fo = (1 - focal_distance / 13100) ** 2
    max_int = 230.0 if channel in (53, 55, 56, 58) else 255.0

    i_adj = np.clip(
        i_orig - 255 * focal_slope * np.abs(fo - (1 - d_orig / 120) ** 2),
        0, max_int,
    )
    ca = i_adj * d_orig**2 / beta_0
    io = i_orig
    wave = np.zeros(m_ext)
    bin_margin = np.inf
    for key, (r_j, ratio) in beam_dict.items():
        if key != -1:
            io = 0.9 * max_int
            ca = io / beta_0
        start = int(np.ceil(r_j * ipm))
        end = int(np.floor((r_j + c * tau_h) * ipm) + 1)
        bin_margin = min(
            bin_margin,
            abs(r_j * ipm - round(r_j * ipm)),
            abs((r_j + c * tau_h) * ipm - round((r_j + c * tau_h) * ipm)),
        )
        amp = ca * beta_0 * ratio * _xsi(r_j) / r_j**2
        for k in range(start, min(end, m_ext)):
            wave[k] += amp * np.sin(PI * (R[k] - r_j) / (c * tau_h)) ** 2

    max_idx = int(np.argmax(wave))
    peak = wave[max_idx]
    d_max = max_idx / ipm - c * tau_h / 2
    second = np.delete(wave, max_idx).max() if m_ext > 1 else 0.0
    i_max = peak + max_int * focal_slope * np.abs(fo - (1 - d_max / 120) ** 2)
    i_max = np.clip(i_max, min_intensity, max_int)
    return dict(
        d_max=d_max,
        i_max=float(i_max),
        peak_tie=(peak - second) / peak if peak > 0 else np.inf,
        range_margin=abs(abs(d_max - d_orig) - 2 / ipm),
        int_margin=float(
            min(i_max - np.floor(i_max), np.ceil(i_max) - i_max)
        ),
        bin_margin=float(bin_margin),
        min_ratio=min(
            (v[1] for k, v in beam_dict.items() if k != -1 and v[1] > 0),
            default=np.inf,
        ),
    )


def hit_set_margins(
    xyz: np.ndarray,
    d_orig: float,
    right_angle: float,
    left_angle: float,
    particles: np.ndarray,
) -> dict:
    """Distances of one beam's particle-intersection predicate to its
    boundaries (simulation.py:345-390): a small value means a particle sits
    on a hit/no-hit edge, so f32 and f64 can disagree about the occluder set
    (label 0 <-> nonzero flips).

    Margins: cull (|particle range - target range|), tangency (|edge-line
    distance - radius|, hit edges only), angle (particle azimuth to a beam
    limit).
    """
    if len(particles) == 0:
        return dict(cull=np.inf, tangency=np.inf, angle=np.inf)
    x, y, r = particles[:, 0], particles[:, 1], particles[:, 2]
    pang = _wrap_02pi(np.arctan2(y, x))
    dist = np.hypot(x, y)
    ar, br = _edge_line_coeffs(np.array([right_angle]))
    al, bl = _edge_line_coeffs(np.array([left_angle]))
    dist_r = np.abs(ar[0] * x + br[0] * y) / np.hypot(ar[0], br[0])
    dist_l = np.abs(al[0] * x + bl[0] * y) / np.hypot(al[0], bl[0])
    ang = np.minimum.reduce([
        np.abs(pang - right_angle),
        np.abs(pang - left_angle),
        np.abs(pang - right_angle + TWO_PI),
        np.abs(pang - left_angle - TWO_PI),
    ])
    return dict(
        cull=float(np.min(np.abs(dist - d_orig))),
        tangency=float(
            np.min(np.minimum(np.abs(dist_r - r), np.abs(dist_l - r)))
        ),
        angle=float(np.min(ang)),
    )


# ----------------------------------------------------------------------------
# full augmentation (semantics of simulation.py:427-544)
# ----------------------------------------------------------------------------

def augment(
    pc: np.ndarray,
    particle_sets: list[np.ndarray],
    calib,
    order: np.ndarray,
    beam_divergence_deg: float,
    noise_floor: float = 0.7,
    plane: tuple | None = None,
    fov_filter=None,
    legacy_sort: bool = False,
    device_semantics: bool = False,
) -> tuple[tuple, np.ndarray]:
    """Full-scan snowfall augmentation.

    particle_sets[i] is the (N_i, 3) particle array of file index i; channel c
    uses particle_sets[order[c]] (the injected shuffle). `plane` optionally
    injects (w, h) to bypass RANSAC. Returns
    ((num_attenuated, num_removed, avg_intensity_diff), augmented cloud).

    legacy_sort=True reproduces the reference's UNSTABLE channel argsort
    (simulation.py:447 uses np.argsort's default introselect), giving
    bit-equal output ROW ORDER vs the reference on the same numpy
    (tests/test_reference_golden.py). The stable default keeps rows aligned
    with the device pipeline; per-row values are identical either way.
    """
    kind = None if legacy_sort else "stable"
    pc = pc[np.argsort(pc[:, 4], kind=kind)]

    if plane is None:
        w, h = ransac_plane(pc[:, :3])
    else:
        w, h = plane
    w = np.asarray(w, dtype=np.float64)

    hog = pc[:, :3] @ w + h
    ground = (hog < 0.5) & (hog > -0.5)
    pcg = pc[ground]

    incident = np.arccos(
        (pcg[:, :3] @ w) / (np.linalg.norm(pcg[:, :3], axis=1) * np.linalg.norm(w))
    )
    _, threshold, _ = estimate_laser_parameters(
        pcg, incident, noise_floor=noise_floor, device_semantics=device_semantics
    )
    threshold = threshold * np.cos(incident)

    gdist = np.linalg.norm(pcg[:, :3], axis=1)
    dist = np.linalg.norm(pc[:, :3], axis=1)
    p = polyfit2(gdist, threshold)
    noise_at_points = p[0] * dist**2 + p[1] * dist + p[2]

    aug = pc.copy()
    intensity_diff_sum = 0.0
    beam_rad = np.radians(beam_divergence_deg)

    for channel in range(calib.num_lasers):
        mask = pc[:, 4] == channel
        if not np.any(mask):
            continue
        cpc = pc[mask]
        d = np.linalg.norm(cpc[:, :3], axis=1)
        center = _wrap_02pi(np.arctan2(cpc[:, 1], cpc[:, 0]))
        beams = np.column_stack([center - beam_rad / 2, center + beam_rad / 2])
        beams = _wrap_02pi(beams)

        occl = occlusion_dicts(
            beams, d, np.asarray(particle_sets[order[channel]]), beam_divergence_deg
        )
        ds, new_cpc = resimulate_channel(
            cpc,
            occl,
            channel,
            float(calib.min_intensity[channel]),
            float(calib.focal_distance[channel]),
            float(calib.focal_slope[channel]),
        )
        intensity_diff_sum += ds
        aug[mask] = new_cpc

    aug[:, 3] = np.round(aug[:, 3])

    keep = (aug[:, 4] == 2) | (aug[:, 3] > noise_at_points)
    num_removed = int((~keep).sum())
    aug = aug[keep]

    num_attenuated = int((aug[:, 4] == 1).sum())
    avg_diff = (
        int(intensity_diff_sum / num_attenuated) if num_attenuated > 0 else 0
    )

    if fov_filter is not None:
        flag = fov_filter(aug[:, :3])
        num_removed += int((~flag).sum())
        aug = aug[flag]

    return (num_attenuated, num_removed, avg_diff), aug
