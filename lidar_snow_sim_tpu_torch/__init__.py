"""lidar_snow_sim_tpu_torch: the snowfall simulation on PyTorch and CUDA.

The port of `lidar_snow_sim_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
H100. Module paths mirror the JAX package's; the JAX package stays the
reference each module is held against. Host-side code that never imports
jax (configs, calibration, particle banks, scan IO, synthetic scenes) is
imported from the JAX package rather than copied, and re-exported here.

Kernels: phase A (`ops/occluders.py`, kernels A1, A2 and A3) and phase C
(`ops/pulse.py`, kernel C1) are hand-written CUDA in `csrc/`, built by
`nvcc` at first use. CUDA tensors go to the kernels, CPU tensors to their
plain torch versions.

This package imports torch and never jax.
"""

from lidar_snow_sim_tpu.calib import SensorCalib, load_hdl64_calib
from lidar_snow_sim_tpu.config import SnowfallConfig, WetGroundConfig
from lidar_snow_sim_tpu.sampling import (
    ParticleBank,
    build_bank,
    compute_occupancy,
    dart_throwing_fast,
    load_bank_files,
    snowfall_rate_to_rainfall_rate,
)
from lidar_snow_sim_tpu.utils.pointcloud import (
    load_velodyne_bin,
    pad_cloud,
    save_velodyne_bin,
)
from lidar_snow_sim_tpu.utils.synthetic import synthetic_scan

__all__ = [
    "SensorCalib",
    "load_hdl64_calib",
    "SnowfallConfig",
    "WetGroundConfig",
    "ParticleBank",
    "build_bank",
    "compute_occupancy",
    "dart_throwing_fast",
    "load_bank_files",
    "snowfall_rate_to_rainfall_rate",
    "load_velodyne_bin",
    "pad_cloud",
    "save_velodyne_bin",
    "synthetic_scan",
]
