"""NumPy oracle: literal reference semantics on host.

The port's copy of `lidar_snow_sim_tpu/oracle/`: the same code with its
imports rewritten, held bitwise against the original by
tests/test_torch_oracle.py. The port's tools (`tools/parity_gpu.py`,
`utils/ground_stats.py`) use this copy.

This sub-package is a clean-room reimplementation of the *semantics* of
SysCV/LiDAR_snow_sim's NumPy pipeline (per-beam occlusion dicts, pulse
re-simulation, wet-ground reflectance). It serves two purposes:

1. The measured CPU baseline for `bench.py` (the reference publishes no
   numbers, so BASELINE.md requires measuring the CPU path).
2. The golden target for parity tests of the TPU kernels.

Deliberate, documented deviations from the reference (each pinned in tests):
- RANSAC plane fit: fixed-trial seeded RANSAC instead of sklearn's
  adaptive-trial RANSACRegressor (stochastic, unpinnable).
- Noise-floor bin choice: lowest index among minimal-count bins (np.argmin)
  instead of np.argpartition's introselect-order-dependent pick
  (reference tools/wet_ground/augmentation.py:236).
- Channel sort is stable (reference uses unstable np.argsort).
- The channel->particle-file shuffle is injected (reference's is unseeded,
  simulation.py:486).
"""

from lidar_snow_sim_tpu_torch.oracle.snowfall import (
    augment as augment_oracle,
    occlusion_dicts,
    resimulate_channel,
)
from lidar_snow_sim_tpu_torch.oracle.fitting import (
    linregress_fit,
    ransac_plane,
    estimate_laser_parameters,
)
from lidar_snow_sim_tpu_torch.oracle.wet_ground import ground_water_augmentation

__all__ = [
    "augment_oracle",
    "occlusion_dicts",
    "resimulate_channel",
    "linregress_fit",
    "ransac_plane",
    "estimate_laser_parameters",
    "ground_water_augmentation",
]
