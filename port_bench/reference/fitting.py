"""The ground plane and the noise floor of one scan in float64 NumPy, as
the port states them (`ops/fitting.ransac_plane`, `ops/laser.py`,
`models/snowfall._plane_and_noise`):

- RANSAC over the reference's road crop (`tools/wet_ground/planes.py:
  12-50`): each trial's three crop points are picked by inverse-CDF
  sampling of the frame's (trials, 3) uniforms over the crop's cumulative
  count, in float32 as the port picks them; the squared residual is held
  against the crop's MAD of z; the first trial with the most inliers wins,
  and its inliers are refitted by least squares; a crop of three points or
  fewer, or a degenerate refit, gives the flat-earth plane.
- the noise floor (`tools/wet_ground/augmentation.py:195-266`): intensities
  of the ground band (|w.p + h| < 0.5) normalized by the cosine of their
  incidence; per 1.2 m distance row of a (50 x 2555) histogram the
  intensity bin with the fewest points (empty bins count as the point
  count, ties to the first bin, as the port pins it); rows above 5 fitted
  linearly (more than three rows, else the power fit), scaled by 0.7 and by
  the cosine again, then a degree-2 fit over range of the ground points.

A copy of the port's oracle (`oracle/fitting.py`) where the two agree.

The row minimum is a discrete choice that the rounding of one point's
normalized intensity or range can move (a point on a bin edge joins the
next bin, and the first bin of fewest points moves hundreds of counts
away), and with it the noise floor by tens of intensity counts: float32
and float64 pick differently on a few frames in a hundred. So
`noise_floors` gives, beside the float64 floor, the floors of the same
histogram with every ground point's range moved by a relative 1e-6 at
most and its normalized intensity by 1e-6 + 4e-7 / cos(incidence) (the
float32 rounding of the incidence's cosine grows as the cosine shrinks
at grazing incidence), each move drawn at random from a fixed set of
draws; the comparison takes a point's keep decision as the reference's
where it matches one of them.
"""

from __future__ import annotations

import numpy as np


def _mad(y):
    return float(np.median(np.abs(y - np.median(y))))


def ransac_plane(xyz, draws, standard_height: float = -1.55):
    """(unit normal w (3,), raw intercept h) of the ground plane of the
    valid points `xyz` (N, 3) on the frame's draws (trials, 3)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    crop = ((z < -1.55) & (z > -1.86 - 0.01 * x) & (x > 10) & (x < 70)
            & (y > -3) & (y < 3))
    p = xyz[crop].astype(np.float64)
    flat = (np.array([0.0, 0.0, 1.0]), standard_height)
    n = len(p)
    if n <= 3:
        return flat
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    thresh = _mad(pz)
    # the k-th crop point for u in [0, 1): float32, as the port picks it
    c = np.float32(n)
    u = np.minimum(np.asarray(draws, np.float32) * c, c - np.float32(0.5))
    idx = np.floor(u).astype(np.int64).clip(0, n - 1)          # (T, 3)
    best, best_count = None, -1
    for t in range(idx.shape[0]):
        a = np.column_stack([px[idx[t]], py[idx[t]], np.ones(3)])
        det = np.linalg.det(a)
        if not np.isfinite(det) or abs(det) <= 1e-6:
            continue
        coef = np.linalg.solve(a, pz[idx[t]])
        if not np.all(np.isfinite(coef)):
            continue
        inliers = (pz - (px * coef[0] + py * coef[1] + coef[2])) ** 2 < thresh
        count = int(inliers.sum())
        if count > best_count:
            best, best_count = inliers, count
    if best is None or best_count < 3:
        return flat
    a = np.column_stack([px[best], py[best], np.ones(best_count)])
    coef, *_ = np.linalg.lstsq(a, pz[best], rcond=None)
    w = np.array([coef[0], coef[1], -1.0])
    h = float(coef[2])
    if not (np.all(np.isfinite(w)) and np.isfinite(h)):
        return flat
    return w / np.linalg.norm(w), h


def linregress_fit(x, y):
    xm, ym = x.mean(), y.mean()
    dx = x - xm
    slope = np.sum(dx * (y - ym)) / np.sum(dx * dx)
    return float(slope), float(ym - slope * xm)


def noise_floor_rows(distance, norm_int, n_points):
    """Per distance row the first intensity bin of fewest points:
    (bin-centre distances, intensity edges) of the rows above 5."""
    hist, xedges, yedges = np.histogram2d(
        distance, norm_int, bins=(50, 2555),
        range=((10.0, 70.0), (5, np.abs(np.max(norm_int)))))
    hist[hist == 0] = n_points
    min_vals = yedges[np.argmin(hist, axis=1)]
    sel = min_vals > 5
    return (xedges[:-1][sel] + xedges[1:][sel]) / 2, min_vals[sel]


def noise_at(xyz, intensity, plane, noise_floor: float = 0.7, jitter=None):
    """The noise threshold at every point's range: the degree-2 fit over
    range of the ground points' thresholds. `jitter` (rng, relative size)
    moves each ground point's range by up to that share and its normalized
    intensity by up to that share plus 0.4 of it over the cosine of its
    incidence, in the histogram alone."""
    w = np.asarray(plane[0], np.float64)
    h = plane[1]
    hog = xyz @ w + h
    ground = (hog < 0.5) & (hog > -0.5)
    if not ground.any():
        # the port's fits over no point give a threshold of 0
        return np.zeros(len(xyz))
    g = xyz[ground]
    gdist = np.linalg.norm(g, axis=1)
    incident = np.arccos(np.clip(
        (g @ w) / (np.maximum(gdist, 1e-12) * np.linalg.norm(w)), -1, 1))
    norm_int = intensity[ground] / np.cos(incident)
    hist_d, hist_v = gdist, norm_int
    if jitter is not None:
        rng, rel = jitter
        hist_v = norm_int * (1 + rel * (1 + 0.4 / np.cos(incident))
                             * rng.uniform(-1, 1, norm_int.shape))
        hist_d = gdist * (1 + rel * rng.uniform(-1, 1, gdist.shape))
    slope, icpt = linregress_fit(gdist, norm_int)
    x, min_vals = noise_floor_rows(hist_d, hist_v, len(g))
    if len(min_vals) > 3:
        slope, icpt = linregress_fit(x, min_vals)
    threshold = noise_floor * (slope * gdist + icpt) * np.cos(incident)
    p = np.polyfit(gdist, threshold, 2)
    dist = np.linalg.norm(xyz, axis=1)
    return p[0] * dist ** 2 + p[1] * dist + p[2]


JITTERS = 32        # the moved histograms of `noise_floors`
JITTER_REL = 1e-6


def noise_floors(xyz, intensity, plane, noise_floor: float = 0.7):
    """[the float64 noise threshold at every point, then the thresholds of
    JITTERS histograms with their points moved by up to JITTER_REL]."""
    out = [noise_at(xyz, intensity, plane, noise_floor)]
    for k in range(JITTERS):
        out.append(noise_at(xyz, intensity, plane, noise_floor,
                            (np.random.default_rng(k), JITTER_REL)))
    return out
