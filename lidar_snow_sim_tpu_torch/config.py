"""Static configuration of the simulation engines (the port's copy of
`lidar_snow_sim_tpu/config.py`: the same fields and defaults, held
against it by tests/test_torch_host.py).

All sizes here are *static* (shape-defining): data-dependent quantities
(particle counts, ground-point counts, ...) are carried as masks/counts at
runtime, and every capacity overflow is counted.

Reference semantics pinned here (file:line refer to SysCV/LiDAR_snow_sim):
- beam divergence default: degrees(3e-3) rad, `tools/snowfall/precompute.py:104`
- lidar_range=120 m, 10 intervals/m, tau_h=1e-8 s, beta_0=1e-6/pi,
  `tools/snowfall/simulation.py:106-109`
- noise_floor=0.7, `tools/snowfall/simulation.py:428`
- wet ground defaults, `tools/wet_ground/augmentation.py:25-27`
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SPEED_OF_LIGHT = 299792458.0  # m/s (scipy.constants.speed_of_light)

# Default beam divergence used by the offline datagen
# (reference tools/snowfall/precompute.py:104): 3 mrad total opening, in degrees.
DEFAULT_BEAM_DIVERGENCE_DEG = float(np.degrees(3e-3))


@dataclasses.dataclass(frozen=True)
class SnowfallConfig:
    """Static configuration of the snowfall augmentation kernel.

    Shape-defining capacities (tune per workload; overflow is *tracked*, never
    silently wrong — see SnowfallResult.diagnostics):

    - max_points:      padded point capacity of one scan
    - window_size:     angular-window candidate capacity per beam (particles
                       gathered from the angle-sorted bank around the beam)
    - wide_capacity:   capacity of the per-bank "wide particle" list (particles
                       whose angular half-width exceeds `wide_threshold`; they
                       are tested against every beam)
    - max_occluders:   max intersecting particles kept per beam for the
                       angular-interval sweep (kept = nearest by range,
                       matching the reference first-claim priority,
                       simulation.py:412-417)
    - max_bumps:       max occluders with nonzero occlusion ratio fed to the
                       pulse re-simulation (plus one hard-target bump)
    """

    # physics / reference constants
    beam_divergence_deg: float = DEFAULT_BEAM_DIVERGENCE_DEG
    noise_floor: float = 0.7
    lidar_range: float = 120.0
    intervals_per_meter: int = 10
    tau_h: float = 1e-8
    beta_0: float = 1e-6 / math.pi
    xsi_r1: float = 0.9   # receiver overlap ramp start (simulation.py:553)
    xsi_r2: float = 1.0   # receiver overlap ramp end
    range_tolerance: float = 0.2  # |d_max - d_orig| threshold (simulation.py:158)

    # capacities (static shapes). Defaults are sized from measured populations
    # on the heaviest reference rate (2.5 mm/h, ~18k particles/channel):
    # window max 64, intersecting occluders max 14, wide particles max 2 —
    # with ~2x headroom. Overflows raise in the host wrapper, never silently
    # truncate, so denser custom banks fail loudly; bump the capacities then.
    max_points: int = 32768
    window_size: int = 128
    wide_capacity: int = 16
    max_occluders: int = 24
    max_bumps: int = 16
    point_chunk: int = 2048

    # candidate windowing
    wide_threshold: float = 5e-3  # rad; particles with angular half-width
    # above this go to the wide list instead of the angle-sorted window

    # dense-slice assembly (assembly="dense"): points are laid out
    # (channel, azimuth)-sorted into (num_channels, channel_capacity) slots;
    # each block of block_points consecutive beams shares ONE contiguous
    # bank slice of slice_width particles (a dynamic slice, not a gather).
    # chunk_group blocks are vmapped per lax.map step for VPU occupancy.
    assembly: str = "window"        # "window" | "dense"
    channel_capacity: int = 1024    # max points per channel (dense)
    block_points: int = 128         # beams per shared slice (dense)
    slice_width: int = 768          # particles per shared slice (dense)
    chunk_group: int = 8            # blocks vmapped together (dense)
    # sweep + pulse re-simulation run only on points with >= 1 occluder,
    # compacted to this capacity (0 = auto: a quarter of the slot count;
    # overflow is counted in compact_overflow and raised by the wrapper).
    # Occluded fraction at the heaviest reference rate is ~20-30%.
    compact_capacity: int = 0
    # phase-D scatter compaction: UNTOUCHED compacted points scatter back
    # bit-identical values (the scale factor is exactly 1.0 and the decision
    # tail keeps the original intensity/label), so only label > 0 points
    # need the intensity+label scatter and only label == 2 points (the ones
    # the pulse MOVES) need the xyz scatters. touch_capacity bounds the
    # intensity scatter set, scatter_capacity the xyz scatter set (0 = auto:
    # 3/4 resp. 1/4 of the compact capacity). Misses count into
    # compact_overflow and the host wrappers grow compact_capacity (auto
    # caps scale along).
    touch_capacity: int = 0
    scatter_capacity: int = 0
    pulse_chunk: int = 2048         # compacted points per pulse-phase step
    # pulse-block width (points): the first of pulse_block, 512, 256, 64
    # dividing the compact capacity; the port reads it only for
    # pulse_pair's even-block-count rule
    pulse_block: int = 512
    # the JAX package's Pallas switches; the port ignores both (a CUDA
    # tensor always takes the kernels, a CPU tensor their plain versions)
    use_pallas: bool = True
    pallas_interpret: bool = False
    # BANDED phase A (kernel A3; default off): each band_group of
    # consecutive beams tests two band_width-wide aligned bands of its
    # chunk's slice (head- and tail-anchored), with a per-beam coverage
    # check counted into window_overflow.
    band_width: int = 0
    band_group: int = 8
    # span-ROUTED phase A (kernel A2; band_width supersedes it): chunks
    # whose every band_group provably fits one route_band-wide 128-aligned
    # window (conservative LUT bounds) test only that band, the rest take
    # the full slice.
    route_band: int = 0
    # phase A on kernel A4b: two chunks per CTA, their column loops
    # interleaved; needs an even chunk count (an odd one runs A1)
    pallas_pair: bool = False
    # phase A on kernel A4a: each beam's candidate columns split across the
    # lanes of a warp. Ignored when band_width, route_band or pallas_pair
    # is set. A4a and A4b compute every chunk (no dead-chunk gate); the
    # outputs the slice reads equal A1's.
    pallas_transposed: bool = False
    # phase C on kernel C2 (two pulse blocks per warp pair, shared trip
    # counts); needs an even count of pulse blocks (else C1 runs)
    pulse_pair: bool = False
    # batched steps (parallel/batched.py): fold the frame batch into one
    # phase-A launch when every frame's kernel is A1; per-frame results are
    # identical
    batch_fold: bool = False

    # plane fit / laser parameter estimation
    ransac_trials: int = 64
    ground_delta: float = 0.5  # |w.p + h| band for ground points (simulation.py:450)

    @property
    def beam_divergence_rad(self) -> float:
        return float(np.radians(self.beam_divergence_deg))

    @property
    def num_bins(self) -> int:
        """Extended waveform grid size (simulation.py:113): ceil(M + c*tau*ipm)."""
        m = self.lidar_range * self.intervals_per_meter
        return int(np.ceil(m + SPEED_OF_LIGHT * self.tau_h * self.intervals_per_meter))

    @property
    def pulse_width_m(self) -> float:
        return SPEED_OF_LIGHT * self.tau_h

    def range_grid(self) -> np.ndarray:
        """The reference's quantized range grid R (simulation.py:116).

        round(linspace(0, range + c*tau, num_bins), 2) computed in float64 on
        host then cast to float32 for the device. The 2-decimal rounding wobble
        (linspace step is 0.10008 m, not 0.1 m) is part of the reference
        semantics and is reproduced exactly.
        """
        extended = self.lidar_range + SPEED_OF_LIGHT * self.tau_h
        r = np.round(np.linspace(0.0, extended, self.num_bins), 2)
        return r.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class WetGroundConfig:
    """Static configuration for wet-ground reflectance augmentation.

    Defaults mirror reference `tools/wet_ground/augmentation.py:25-27`.
    """

    water_height: float = 0.001
    pavement_depth: float = 0.0012
    noise_floor: float = 0.7
    power_factor: float = 15.0
    estimation_method: str = "linear"  # 'linear' | 'poly'
    flat_earth: bool = False
    delta: float = 0.5
    replace: bool = True
    min_ground_points: int = 1000  # bail-out threshold (augmentation.py:51)
    n_air: float = 1.0003
    n_water: float = 1.33
    min_reflectivity: float = 0.05
    ransac_trials: int = 64


@dataclasses.dataclass(frozen=True)
class PlaneFitConfig:
    """RANSAC ground-plane fit configuration.

    Mirrors the semantics of reference `tools/wet_ground/planes.py:12-50`
    (sklearn RANSACRegressor with squared loss against a MAD threshold, then a
    least-squares refit on the best trial's inliers) with a fixed, seeded trial
    count so results are reproducible on device.
    """

    trials: int = 64
    min_samples: int = 3
    standard_height: float = -1.55
    # ground crop (planes.py:21-26)
    x_min: float = 10.0
    x_max: float = 70.0
    y_abs: float = 3.0
    z_max: float = -1.55
    z_slope: float = -0.01
    z_base: float = -1.86


def config_from_jax(cfg):
    """The port's config of the same class name (`SnowfallConfig`,
    `WetGroundConfig` or `PlaneFitConfig`) from any dataclass with the same
    fields, such as the JAX package's. Raises on a field the port's class
    does not have."""
    classes = {c.__name__: c for c in (SnowfallConfig, WetGroundConfig,
                                       PlaneFitConfig)}
    cls = classes.get(type(cfg).__name__)
    if cls is None or not dataclasses.is_dataclass(cfg):
        raise TypeError(f"no port config for {type(cfg).__name__}")
    values = dataclasses.asdict(cfg)
    unknown = sorted(set(values) - {f.name for f in dataclasses.fields(cls)})
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {unknown}")
    return cls(**values)
