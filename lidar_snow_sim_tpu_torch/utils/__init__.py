from lidar_snow_sim_tpu_torch.utils.pointcloud import (
    PaddedCloud,
    compact_cloud,
    load_velodyne_bin,
    pad_cloud,
    save_velodyne_bin,
)
from lidar_snow_sim_tpu_torch.utils.splits import read_split
from lidar_snow_sim_tpu_torch.utils.synthetic import synthetic_scan

__all__ = [
    "PaddedCloud",
    "compact_cloud",
    "load_velodyne_bin",
    "pad_cloud",
    "read_split",
    "save_velodyne_bin",
    "synthetic_scan",
]
