"""Empirical incidence-range analysis of sampled particle fields (the
port's copy of `lidar_snow_sim_tpu/sampling/empirical.py`).

Equivalent of `tools/snowfall/sampling.py:197-278`
(`incidence_range_empirical_distribution`): cast rays from the origin through
a sampled 2-D particle field and record the range each ray travels before
first hitting a particle disk (R_0 if it escapes the domain). The reference is
a double Python loop over directions x particles; here it is one vectorized
(n_directions, n_particles) computation (NumPy on host, since this is offline
bank analysis, not the augmentation hot path).
"""

from __future__ import annotations

import numpy as np


def incidence_range_empirical_distribution(
    samples: np.ndarray,
    R_0: float,
    n_directions: int,
    sample_regular_directions: bool = True,
    rng: np.random.Generator | None = None,
):
    """(ranges_travelled, directions) over rays from the origin.

    samples: (N, 3) rows (x_center, y_center, radius). Ray i at angle
    directions[i] travels until the first disk intersection; misses record
    R_0.
    """
    samples = np.asarray(samples, dtype=np.float64)
    if sample_regular_directions:
        directions = np.linspace(0.0, 2.0 * np.pi, n_directions, endpoint=False)
    else:
        if rng is None:
            rng = np.random.default_rng()
        directions = rng.uniform(0.0, 2.0 * np.pi, n_directions)

    if len(samples) == 0:
        return np.full(n_directions, R_0), directions

    cx, cy, r = samples[:, 0], samples[:, 1], samples[:, 2]
    cos_d = np.cos(directions)[:, None]  # (D, 1)
    sin_d = np.sin(directions)[:, None]

    # along-ray and perpendicular components of each center (D, N)
    t = cx[None, :] * cos_d + cy[None, :] * sin_d
    perp = np.abs(cx[None, :] * sin_d - cy[None, :] * cos_d)

    hit = (perp <= r[None, :]) & (t > 0)
    # first-intersection range: t - sqrt(r^2 - perp^2)
    half_chord = np.sqrt(np.maximum(r[None, :] ** 2 - perp**2, 0.0))
    entry = np.where(hit, t - half_chord, np.inf)
    ranges = np.minimum(entry.min(axis=1), R_0)
    return np.maximum(ranges, 0.0), directions
