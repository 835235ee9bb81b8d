"""Sensor calibration → device LUT (the port's copy of
`lidar_snow_sim_tpu/calib.py`, held bitwise against it by
tests/test_torch_host.py).

The reference reads a 242-line Velodyne HDL-64E S3 factory YAML on every
`augment()` call and indexes per-channel dicts inside the per-channel worker
(reference `tools/snowfall/simulation.py:72-76,474-480`). Here the calibration
is parsed once on host into flat float32 arrays (a `SensorCalib`) that live on
device and are gathered per point inside the jitted kernel.

Consumed fields per laser (simulation.py:72-76):
- min_intensity   (missing for lasers 34..63 → default 0, `.get(...,0)`)
- focal_distance  (used as focal_distance * 100)
- focal_slope
- derived focal_offset = (1 - focal_distance*100 / 13100)^2  ("velodyne manual")

Channels {53, 55, 56, 58} have max_intensity 230, all others 255
(simulation.py:123-126).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np

_DATA_DIR = Path(__file__).parent / "data"
_SPECIAL_MAX_230 = (53, 55, 56, 58)


class SensorCalib(NamedTuple):
    """Per-channel calibration LUT (all shape (num_lasers,) float32)."""

    min_intensity: np.ndarray   # float32
    focal_distance: np.ndarray  # float32, already scaled *100
    focal_slope: np.ndarray     # float32
    focal_offset: np.ndarray    # float32, (1 - fd/13100)^2
    max_intensity: np.ndarray   # float32, 230 or 255
    vert_correction: np.ndarray  # float32, radians (for synthetic scan gen)

    @property
    def num_lasers(self) -> int:
        return int(self.min_intensity.shape[0])


def _from_laser_rows(rows: list[dict], num_lasers: int) -> SensorCalib:
    rows = sorted(rows, key=lambda r: r["laser_id"])
    assert len(rows) == num_lasers, f"expected {num_lasers} lasers, got {len(rows)}"
    min_int = np.array(
        [r.get("min_intensity") or 0 for r in rows], dtype=np.float32
    )
    fd = np.array([r["focal_distance"] * 100.0 for r in rows], dtype=np.float32)
    fs = np.array([r["focal_slope"] for r in rows], dtype=np.float32)
    fo = ((1.0 - fd / 13100.0) ** 2).astype(np.float32)
    max_int = np.full(num_lasers, 255.0, dtype=np.float32)
    for ch in _SPECIAL_MAX_230:
        if ch < num_lasers:
            max_int[ch] = 230.0
    vert = np.array(
        [r.get("vert_correction", 0.0) for r in rows], dtype=np.float32
    )
    return SensorCalib(min_int, fd, fs, fo, max_int, vert)


def load_hdl64_calib(path: str | Path | None = None) -> SensorCalib:
    """Load the bundled HDL-64E S3 calibration (or a compatible JSON file)."""
    p = Path(path) if path is not None else _DATA_DIR / "hdl64_s3.json"
    with open(p) as f:
        d = json.load(f)
    return _from_laser_rows(d["lasers"], d["num_lasers"])


def load_velodyne_yaml(path: str | Path) -> SensorCalib:
    """Parse a Velodyne factory-calibration YAML (same schema the reference
    reads at simulation.py:474-480) into a SensorCalib."""
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f)
    return _from_laser_rows(d["lasers"], d["num_lasers"])
