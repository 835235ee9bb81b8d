"""lidar_snow_sim_tpu_torch: the snowfall simulation on PyTorch and CUDA.

The port of `lidar_snow_sim_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
H100. Module paths mirror the JAX package's; the JAX package stays the
reference each module is held against. The port imports nothing of the JAX
package: the host-side modules it needs (configs, calibration, particle
banks, scan IO, synthetic scenes, the Mie bake) are its own copies, held
bitwise against the originals by tests/test_torch_host.py, and re-exported
here with the converters `config_from_jax` and `bank_from_numpy`.

Kernels: phase A (`ops/occluders.py`, kernels A1, A2, A3, A4a and A4b),
phase C (`ops/pulse.py`, kernels C1 and C2) and LISA's Qback lookup
(`ops/lut_lookup.py`, kernel L1) are hand-written CUDA in `csrc/`, built by
`nvcc` at first use. CUDA tensors go to the kernels, CPU tensors to their
plain torch versions. The entry points run on the card (device "cuda")
unless the CPU is asked for, and raise where there is no card. Beside
snowfall and wet ground, `models/` holds the viewer's weather baselines
(LISA, fog, STF fog, DROR), which `tools/inspect.py` drives, and the
PointPillars detector's inference (`models/pointpillars.py`,
`ops/rotated_iou.py`), which `tools/infer.py` drives; it has no kernel of
its own (cuDNN convolutions and torch ops). `oracle/` is the NumPy
reference semantics (a copy of the JAX package's), which
`tools/parity_gpu.py` holds the card's output against; `native.py` binds
the repo's `native/` C++ (the bank sampler of `tools/gen_banks.py`).

This package imports torch and never jax.
"""

from lidar_snow_sim_tpu_torch.calib import SensorCalib, load_hdl64_calib
from lidar_snow_sim_tpu_torch.config import (
    SnowfallConfig,
    WetGroundConfig,
    config_from_jax,
)
from lidar_snow_sim_tpu_torch.sampling import (
    ParticleBank,
    bank_from_numpy,
    build_bank,
    compute_occupancy,
    dart_throwing_fast,
    load_bank_files,
    snowfall_rate_to_rainfall_rate,
)
from lidar_snow_sim_tpu_torch.utils.pointcloud import (
    load_velodyne_bin,
    pad_cloud,
    save_velodyne_bin,
)
from lidar_snow_sim_tpu_torch.utils.synthetic import synthetic_scan

__all__ = [
    "SensorCalib",
    "load_hdl64_calib",
    "SnowfallConfig",
    "WetGroundConfig",
    "config_from_jax",
    "ParticleBank",
    "bank_from_numpy",
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
