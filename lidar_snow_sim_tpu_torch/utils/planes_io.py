"""Ground-plane export utilities (host side; the port's copy of
`lidar_snow_sim_tpu/utils/planes_io.py`).

Equivalents of the reference's plane persistence surface
(`tools/wet_ground/planes.py:53-80`): transform a LiDAR-frame ground plane
(normal w, height h) into camera extrinsics and write the 4-value KITTI-style
plane file consumed by downstream detectors.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def transform_results_to_camera_extrinsics(projection_matrix, w, h):
    """(w_cam, h_projected): plane normal/height in camera coordinates.

    projection_matrix is a (3, 4) or (4, 4) LiDAR->camera transform; the
    normal is rotated by its 3x3 block and the height re-projected onto it
    (`planes.py:67-80`).
    """
    pm = np.asarray(projection_matrix, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    w_cam = pm[:3, :3] @ w
    h_cam = (pm[:3] @ np.array([0.0, 0.0, float(h), 1.0]))[:3]
    return w_cam, float(w_cam @ h_cam)


def save_plane(destination_path, file_name, w_in, h_in, projection_matrix):
    """Write the 4-parameter plane file format (`planes.py:53-64`):
    a '# Plane' header, Width/Height counts, then `wx wy wz h`."""
    w, h_projected = transform_results_to_camera_extrinsics(
        projection_matrix, w_in, h_in
    )
    os.makedirs(destination_path, exist_ok=True)
    body = "\n".join(
        [
            "# Plane",
            "Width 4",
            "Height 1",
            "{:e} {:e} {:e} {:e}".format(w[0], w[1], w[2], h_projected),
        ]
    )
    Path(os.path.join(destination_path, file_name)).write_text(body)


def write_csv(name, x_data, y_data, label_file="undefined",
              folder="statistics_output"):
    """Two-column x/y CSV dump with header row (phy_equations.py:189-201)."""
    import csv

    os.makedirs(folder, exist_ok=True)
    with open(f"{folder}/{label_file}_{name}.csv", "w", newline="") as f:
        writer = csv.writer(f, delimiter=",")
        writer.writerow(["x_data", "y_data"])
        for x, y in zip(x_data, y_data):
            writer.writerow([x, y])
