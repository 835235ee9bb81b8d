"""Snowfall physics: rate conversions, occupancy, size distributions
(the port's copy of `lidar_snow_sim_tpu/sampling/distributions.py`).

Reference semantics (`tools/snowfall/sampling.py:23-87`):
- occupancy = (rho_water * S) / (3.6e6 * rho_snow * v_terminal)
- S→R: R = sqrt((S / (487 * rho_s * d_s * v))^3), d_s = 0.003 m default
- size-distribution rate parameter [1/cm]:
  Sekhon–Srivastava (1970): 22.9 * R^-0.45
  Gunn–Marshall (1958):     25.5 * R^-0.48
"""

from __future__ import annotations

import numpy as np


def compute_occupancy(
    snowfall_rate: float, terminal_velocity: float, snow_density: float = 0.1
) -> float:
    """Areal occupancy ratio of snow particles in a horizontal plane.

    snowfall_rate in mm/h, terminal_velocity in m/s, snow_density in g/cm^3.
    """
    water_density = 1.0
    # literal operand grouping of sampling.py:33 (bit-equal result matters:
    # occupancy feeds the reference's particle-bank file names)
    return (water_density * snowfall_rate) / (
        (3.6 * 10**6) * (snow_density * terminal_velocity)
    )


def rainfall_rate_to_snowfall_rate(
    rainfall_rate: float,
    terminal_velocity: float,
    snowflake_density: float = 0.1,
    snowflake_diameter: float = 0.003,
) -> float:
    return (
        487.0
        * snowflake_density
        * snowflake_diameter
        * terminal_velocity
        * rainfall_rate ** (2.0 / 3.0)
    )


def snowfall_rate_to_rainfall_rate(
    snowfall_rate: float,
    terminal_velocity: float,
    snowflake_density: float = 0.1,
    snowflake_diameter: float = 0.003,
) -> float:
    base = snowfall_rate / (
        487.0 * snowflake_density * snowflake_diameter * terminal_velocity
    )
    return float(np.sqrt(base**3))


def sekhon_srivastava(precipitation_rate: float) -> float:
    """Exponential-size-distribution rate parameter [1/cm], Sekhon & Srivastava 1970."""
    return 22.9 * precipitation_rate**-0.45


def gunn_marshall(precipitation_rate: float) -> float:
    """Exponential-size-distribution rate parameter [1/cm], Gunn & Marshall 1958."""
    return 25.5 * precipitation_rate**-0.48


def diameter_rate_parameter(distribution: str, precipitation_rate: float) -> float:
    if distribution == "sekhon":
        return sekhon_srivastava(precipitation_rate)
    if distribution == "gunn":
        return gunn_marshall(precipitation_rate)
    raise NotImplementedError(f"unknown size distribution {distribution!r}")


def datagen_combos(
    snowfall_rates=(0.5, 1.0, 2.0, 2.5, 1.5),
    terminal_velocities=(2.0, 1.6, 2.0, 1.6, 0.6),
):
    """(rainfall_rate, occupancy) combos of the offline datagen
    (`tools/snowfall/precompute.py:20-21,53-60`)."""
    assert len(snowfall_rates) == len(terminal_velocities)
    return [
        (
            snowfall_rate_to_rainfall_rate(s, v),
            compute_occupancy(s, v),
        )
        for s, v in zip(snowfall_rates, terminal_velocities)
    ]
