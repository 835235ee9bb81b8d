from lidar_snow_sim_tpu_torch.sampling.distributions import (
    compute_occupancy,
    snowfall_rate_to_rainfall_rate,
    rainfall_rate_to_snowfall_rate,
    sekhon_srivastava,
    gunn_marshall,
)
from lidar_snow_sim_tpu_torch.sampling.dart import dart_throwing, dart_throwing_fast
from lidar_snow_sim_tpu_torch.sampling.banks import (
    ParticleBank,
    bank_from_numpy,
    build_bank,
    load_bank_files,
)

__all__ = [
    "compute_occupancy",
    "snowfall_rate_to_rainfall_rate",
    "rainfall_rate_to_snowfall_rate",
    "sekhon_srivastava",
    "gunn_marshall",
    "dart_throwing",
    "dart_throwing_fast",
    "ParticleBank",
    "bank_from_numpy",
    "build_bank",
    "load_bank_files",
]
