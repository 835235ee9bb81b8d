"""Dataset paths (the port's copy of the part of
`lidar_snow_sim_tpu/utils/datasets.py` that the inspect CLI calls).
"""

from __future__ import annotations

from pathlib import Path


def find_camera_image(scan_path: str | Path) -> Path | None:
    """The synchronized camera frame of a DENSE scan (`populate_image`,
    `pointcloud_viewer.py:3053-3065`): ``../cam_stereo_left_lut/<stem>.png``
    relative to the lidar folder. Returns None when absent."""
    p = Path(scan_path)
    img = p.parent.parent / "cam_stereo_left_lut" / (p.stem + ".png")
    return img if img.exists() else None
