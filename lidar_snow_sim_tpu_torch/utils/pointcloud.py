"""Point-cloud IO and fixed-shape padding (the port's copy of
`lidar_snow_sim_tpu/utils/pointcloud.py`).

The on-disk format matches the reference (STF/DENSE Velodyne binary, N-by-5
float32 rows: x, y, z, intensity, channel — `tools/wet_ground/utils.py:31-34`).
On device, ragged scans are carried as (max_points, 5) float32 plus a validity
mask so whole batches compile to fixed shapes.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np


class PaddedCloud(NamedTuple):
    """A fixed-shape scan: (N_max, 5) float32 points + (N_max,) bool mask."""

    points: np.ndarray  # (N_max, 5) float32
    mask: np.ndarray    # (N_max,) bool

    @property
    def capacity(self) -> int:
        return int(self.points.shape[-2])


def load_velodyne_bin(path: str | Path, columns: int = 5) -> np.ndarray:
    """Load a Velodyne .bin scan as an (N, columns) float32 array."""
    scan = np.fromfile(str(path), dtype=np.float32)
    return scan.reshape(-1, columns)


def save_velodyne_bin(points: np.ndarray, path: str | Path) -> None:
    points.astype(np.float32).tofile(str(path))


def pad_cloud(points: np.ndarray, capacity: int) -> PaddedCloud:
    """Pad an (N, 5) scan to (capacity, 5) with a validity mask.

    Padding rows are placed far outside the scene (x=1e6) with channel 0 so
    they never enter ground masks or angular windows; every kernel also applies
    the mask explicitly.
    """
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"scan has {n} points > capacity {capacity}")
    out = np.zeros((capacity, points.shape[1]), dtype=np.float32)
    out[:, 0] = 1e6
    out[:n] = points.astype(np.float32)
    mask = np.zeros(capacity, dtype=bool)
    mask[:n] = True
    return PaddedCloud(out, mask)


def compact_cloud(points: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Host-side compaction: drop rows where keep is False, preserving order."""
    points = np.asarray(points)
    keep = np.asarray(keep)
    return points[keep]
