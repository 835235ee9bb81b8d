"""Ground-plane intensity statistics (host-side analysis; the port's copy
of `lidar_snow_sim_tpu/utils/ground_stats.py`, on the port's oracle).

Equivalent of the reference's wet-ground analysis helper
`get_ground_plane_intensity_stats` (`tools/wet_ground/augmentation.py:269-333`),
used to study how ground reflectance varies with distance and road wetness:
fit the ground plane, crop the in-trajectory ground band, estimate laser
parameters, and build the per-distance cumulative intensity distribution.
Plotting is left to the caller (the returned arrays feed a pcolormesh
directly); the reference's None-tuple bail-outs are preserved.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class GroundIntensityStats(NamedTuple):
    poly: np.ndarray | None        # relative-output fit coefficients
    distances: np.ndarray | None   # (D,) filled distance-bin centers
    hist_probs: np.ndarray | None  # (D, 255) per-distance intensity pmf
    cumsum: np.ndarray | None      # (D, 255) cumulative distribution
    filled_idx: np.ndarray | None  # indices of non-empty distance bins


def ground_plane_intensity_stats(
    pointcloud: np.ndarray,
    *,
    delta: float = 0.3,
    trajectory_half_width: float = 1.5,
    max_intensity: float = 200.0,
    min_ground_points: int = 1000,
    seed: int = 0,
) -> GroundIntensityStats:
    """Per-distance intensity distribution over the in-trajectory ground band.

    Mirrors the reference semantics: ground band |w.p + h| < delta, restricted
    to |y| < trajectory_half_width and intensity < max_intensity; bails out
    (all-None result) with fewer than `min_ground_points` candidates.
    """
    from lidar_snow_sim_tpu_torch.oracle.fitting import ransac_plane

    pc = np.asarray(pointcloud, dtype=np.float64)
    w, h = ransac_plane(pc[:, :3], seed=seed)
    hog = pc[:, :3] @ np.asarray(w)
    ground = (hog + h < delta) & (hog + h > -delta)
    if ground.sum() < min_ground_points:
        return GroundIntensityStats(None, None, None, None, None)
    ground &= (
        (pc[:, 1] > -trajectory_half_width)
        & (pc[:, 1] < trajectory_half_width)
        & (pc[:, 3] < max_intensity)
    )
    g = pc[ground]
    if len(g) == 0:
        return GroundIntensityStats(None, None, None, None, None)

    distance = np.linalg.norm(g[:, :3], axis=1)
    # relative output power: degree-2 fit of cos-normalized intensity
    incident = np.arccos(
        np.clip(
            (g[:, :3] @ np.asarray(w))
            / (np.maximum(distance, 1e-12) * np.linalg.norm(w)),
            -1.0,
            1.0,
        )
    )
    normalized = g[:, 3] / np.maximum(np.cos(incident), 1e-6)
    poly = np.polyfit(distance, normalized, 2)

    hist, xedges, _ = np.histogram2d(
        distance, g[:, 3], bins=(50, 255), range=((10, 70), (0, 255))
    )
    x = (xedges[:-1] + xedges[1:]) / 2
    sums = hist.sum(axis=1)
    filled = np.where(sums > 0)[0]
    if len(filled) == 0:
        return GroundIntensityStats(poly, None, None, None, None)
    hist = hist[filled]
    probs = hist / sums[filled][:, None]
    return GroundIntensityStats(
        poly=poly,
        distances=x[filled],
        hist_probs=probs,
        cumsum=np.cumsum(probs, axis=1),
        filled_idx=filled,
    )
