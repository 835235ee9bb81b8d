"""The benchmark's inputs, made from a run's seed by the benchmark's own
frozen NumPy copies of the generators (held equal to the port's by
port_bench/tests/test_port_bench_reference.py).

- `synthetic_scan`: an HDL-64E-like scan (x, y, z, intensity, channel),
  the port's `utils/synthetic.synthetic_scan`.
- `dart_throwing_fast`: one channel's snow particles (x, y, disk radius),
  the port's `sampling/dart.dart_throwing_fast`, with the rate conversions
  of `sampling/distributions.py`.
- `load_calib`: the HDL-64E S3 per-laser calibration, parsed from the
  JSON file the port ships (`lidar_snow_sim_tpu_torch/data/hdl64_s3.json`).
- `frame_pool`: the run's pool of frames: scans, channel orders and RANSAC
  seeds, all drawn from the run's seed.

The particle sets of a configuration's bank are drawn from the bank's own
seed (the configuration's file), not the run's: a precomputed bank is part
of a deployment, and every run then does the same work. They are cached in
`port_bench/_cache/`, so only a checkout's first run draws them.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

from port_bench.spec import CHECKOUT, ROOT

CACHE = ROOT / "_cache"
CALIB_JSON = CHECKOUT / "lidar_snow_sim_tpu_torch" / "data" / "hdl64_s3.json"
SPECIAL_MAX_230 = (53, 55, 56, 58)


class Calib(NamedTuple):
    """Per-laser calibration, float32 arrays of (num_lasers,)."""

    min_intensity: np.ndarray
    focal_distance: np.ndarray   # scaled by 100
    focal_slope: np.ndarray
    focal_offset: np.ndarray
    max_intensity: np.ndarray
    vert_correction: np.ndarray  # radians

    @property
    def num_lasers(self) -> int:
        return int(self.min_intensity.shape[0])


def load_calib(path: Path = CALIB_JSON) -> Calib:
    with open(path) as f:
        d = json.load(f)
    rows = sorted(d["lasers"], key=lambda r: r["laser_id"])
    if len(rows) != d["num_lasers"]:
        raise ValueError(f"{path}: {len(rows)} lasers, {d['num_lasers']} "
                         "declared")
    fd = np.array([r["focal_distance"] * 100.0 for r in rows], np.float32)
    max_int = np.full(len(rows), 255.0, np.float32)
    max_int[[c for c in SPECIAL_MAX_230 if c < len(rows)]] = 230.0
    return Calib(
        min_intensity=np.array([r.get("min_intensity") or 0 for r in rows],
                               np.float32),
        focal_distance=fd,
        focal_slope=np.array([r["focal_slope"] for r in rows], np.float32),
        focal_offset=((1.0 - fd / 13100.0) ** 2).astype(np.float32),
        max_intensity=max_int,
        vert_correction=np.array([r.get("vert_correction", 0.0)
                                  for r in rows], np.float32),
    )


def synthetic_scan(calib: Calib, n_azimuth: int = 870, fov_deg: float = 87.0,
                   sensor_height: float = 1.75, max_range: float = 80.0,
                   seed: int = 0, n_boxes: int = 12) -> np.ndarray:
    """An (N, 5) float32 scan over the forward camera field of view: a
    near-flat rough ground 1.75 m below the sensor and `n_boxes` boxes off
    the driving corridor, ray-cast per (channel, azimuth), with a
    distance-decaying intensity; 5% of the returns dropped at random."""
    rng = np.random.default_rng(seed)
    n_ch = calib.num_lasers
    az = np.radians(np.linspace(-fov_deg / 2, fov_deg / 2, n_azimuth))
    az_g, el_g = np.meshgrid(az, calib.vert_correction)
    ch_g = np.broadcast_to(np.arange(n_ch)[:, None], az_g.shape)
    dir_x = np.cos(el_g) * np.cos(az_g)
    dir_y = np.cos(el_g) * np.sin(az_g)
    dir_z = np.sin(el_g)

    slope_x = rng.uniform(-0.003, 0.003)
    slope_y = rng.uniform(-0.002, 0.002)
    denom = dir_z - slope_x * dir_x - slope_y * dir_y
    t_ground = np.where(denom < -1e-4, -sensor_height / denom, np.inf)
    rough = rng.normal(0.0, 0.02, size=t_ground.shape)
    t_ground = t_ground * (1.0 + np.where(np.isfinite(t_ground),
                                          rough / 80.0, 0.0))
    t_ground = t_ground + np.where(np.isfinite(t_ground), rough, 0.0)

    t_hit = t_ground.copy()
    refl = np.full(az_g.shape, 0.12)
    for _ in range(n_boxes):
        bx = rng.uniform(8, 60)
        by = rng.uniform(4.5, 15.0) * rng.choice((-1.0, 1.0))
        bw, bl, bh = rng.uniform(1, 4, size=3) * np.array([1, 1.5, 1.0])
        box_refl = rng.uniform(0.2, 0.9)
        with np.errstate(divide="ignore", invalid="ignore"):
            tx0 = (bx - bw) / dir_x
            tx1 = (bx + bw) / dir_x
            ty0 = np.where(np.abs(dir_y) > 1e-9, (by - bl) / dir_y, -np.inf)
            ty1 = np.where(np.abs(dir_y) > 1e-9, (by + bl) / dir_y, np.inf)
        t_near = np.maximum(np.minimum(tx0, tx1), np.minimum(ty0, ty1))
        t_far = np.minimum(np.maximum(tx0, tx1), np.maximum(ty0, ty1))
        z_at = t_near * dir_z
        hits = ((t_near > 0.5) & (t_near < t_far) & (z_at > -sensor_height)
                & (z_at < -sensor_height + bh) & (t_near < t_hit))
        refl = np.where(hits, box_refl, refl)
        t_hit = np.where(hits, t_near, t_hit)

    valid = np.isfinite(t_hit) & (t_hit > 1.0) & (t_hit < max_range)
    t = np.where(valid, t_hit, 1.0)
    x, y, z = (t * dir_x)[valid], (t * dir_y)[valid], (t * dir_z)[valid]
    d, r = t[valid], refl[valid]
    ch = ch_g[valid].astype(np.float32)
    cos_inc = np.where(r < 0.15, sensor_height / np.maximum(d, 1e-3), 0.9)
    cos_inc = np.clip(cos_inc, 0.02, 1.0)
    intensity = (40.0 + 2.2 * d) * cos_inc * (r / 0.12)
    intensity += rng.normal(0, 2.0, size=intensity.shape)
    intensity = np.clip(np.round(intensity), 0, 255)
    pc = np.column_stack([x, y, z, intensity, ch]).astype(np.float32)
    keep = rng.uniform(size=len(pc)) > 0.05
    return pc[keep]


def rainfall_rate(snowfall_rate: float, terminal_velocity: float) -> float:
    """The snowfall rate's rainfall-rate equivalent (mm/h), snowflake
    density 0.1 g/cm^3 and diameter 3 mm."""
    base = snowfall_rate / (487.0 * 0.1 * 0.003 * terminal_velocity)
    return float(np.sqrt(base ** 3))


def occupancy(snowfall_rate: float, terminal_velocity: float) -> float:
    """Areal occupancy ratio of the particles (snow density 0.1 g/cm^3)."""
    return (1.0 * snowfall_rate) / ((3.6 * 10 ** 6)
                                   * (0.1 * terminal_velocity))


def diameter_rate(mode: str, precipitation_rate: float) -> float:
    """The exponential size distribution's rate parameter [1/cm]."""
    if mode == "sekhon":
        return 22.9 * precipitation_rate ** -0.45
    if mode == "gunn":
        return 25.5 * precipitation_rate ** -0.48
    raise ValueError(f"unknown size distribution {mode!r}")


def dart_throwing_fast(occupancy_ratio: float, precipitation_rate: float,
                       R_0: float, rng: np.random.Generator,
                       distribution: str = "sekhon", batch: int = 131072,
                       max_diameter_mm: float = 20.0) -> np.ndarray:
    """(N, 3) [x, y, disk radius] of non-overlapping particle disks in a
    disk of radius R_0, none covering the origin, drawn in batches of
    proposals until their area reaches the occupancy; overlaps found with
    a uniform spatial hash."""
    scale_mm = (1.0 / diameter_rate(distribution, precipitation_rate)) * 10.0
    area_target = occupancy_ratio * np.pi * R_0 ** 2
    inv_cell = 1.0 / (max_diameter_mm / 1000.0)
    grid: dict[int, list[int]] = {}
    key = 1 << 21
    n_acc, area = 0, 0.0
    ax_buf, ay_buf, ar_buf = (np.empty(1 << 22) for _ in range(3))
    while area < area_target:
        length = np.sqrt(rng.uniform(0, R_0 ** 2, size=batch))
        angle = rng.uniform(0, 2, size=batch) * np.pi
        x = length * np.cos(angle)
        y = length * np.sin(angle)
        d = rng.exponential(scale_mm, size=batch)
        over = d > max_diameter_mm
        while np.any(over):
            d[over] = rng.exponential(scale_mm, size=int(over.sum()))
            over = d > max_diameter_mm
        d = d / 1000.0
        h = rng.uniform(-d / 2, d / 2)
        r = np.sqrt((d / 2) ** 2 - h ** 2)
        ok = x ** 2 + y ** 2 > r ** 2
        x, y, r = x[ok], y[ok], r[ok]
        ix = np.floor((x + 2 * R_0) * inv_cell).astype(np.int64)
        iy = np.floor((y + 2 * R_0) * inv_cell).astype(np.int64)
        keys = ix * key + iy
        for i in range(len(x)):
            xi, yi, ri, ki = x[i], y[i], r[i], keys[i]
            hit = False
            for dk in (-key - 1, -key, -key + 1, -1, 0, 1, key - 1, key,
                       key + 1):
                for j in grid.get(ki + dk, ()):
                    dx = ax_buf[j] - xi
                    dy = ay_buf[j] - yi
                    rr = ar_buf[j] + ri
                    if dx * dx + dy * dy <= rr * rr:
                        hit = True
                        break
                if hit:
                    break
            if hit:
                continue
            if n_acc >= len(ax_buf):
                ax_buf = np.concatenate([ax_buf, np.empty_like(ax_buf)])
                ay_buf = np.concatenate([ay_buf, np.empty_like(ay_buf)])
                ar_buf = np.concatenate([ar_buf, np.empty_like(ar_buf)])
            ax_buf[n_acc], ay_buf[n_acc], ar_buf[n_acc] = xi, yi, ri
            grid.setdefault(int(ki), []).append(n_acc)
            n_acc += 1
            area += np.pi * ri * ri
            if area >= area_target:
                break
    return np.column_stack([ax_buf[:n_acc], ay_buf[:n_acc], ar_buf[:n_acc]])


def particle_sets(bank: dict, cache: Path = CACHE) -> list[np.ndarray]:
    """The configuration's bank: `bank["sets"]` particle sets of its mode,
    rate and velocity, drawn from `bank["seed"]`, cached as an .npz."""
    name = (f"bank_{bank['mode']}_{bank['snowfall_rate']}_"
            f"{bank['terminal_velocity']}_{bank['R_0']}_{bank['sets']}_"
            f"{bank['seed']}.npz")
    path = cache / name
    if path.exists():
        with np.load(path) as z:
            return [z[f"c{i}"] for i in range(bank["sets"])]
    rr = rainfall_rate(bank["snowfall_rate"], bank["terminal_velocity"])
    occ = occupancy(bank["snowfall_rate"], bank["terminal_velocity"])
    rng = np.random.default_rng(bank["seed"])
    sets = [dart_throwing_fast(occ, rr, bank["R_0"], rng, bank["mode"])
            for _ in range(bank["sets"])]
    cache.mkdir(parents=True, exist_ok=True)
    # written aside and renamed: a reader never sees a partial file
    tmp = path.with_name(f"{path.stem}.partial.{os.getpid()}.npz")
    np.savez(tmp, **{f"c{i}": s for i, s in enumerate(sets)})
    os.replace(tmp, path)
    return sets


class Frame(NamedTuple):
    """One frame of the pool: a scan, its channel -> bank-row order and
    the seed of its RANSAC draws."""

    scan: np.ndarray     # (N, 5) float32
    order: np.ndarray    # (num_lasers,) int64
    ransac_seed: int


def frame_pool(seed: int, scan: dict, calib: Calib) -> list[Frame]:
    """`scan["pool"]` frames drawn from the run's seed: each scan from its
    own seed, then its channel order and its RANSAC seed (below 2**31, as
    the port's datagen draws it)."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x5CA7])
    out = []
    for _ in range(scan["pool"]):
        pc = synthetic_scan(calib, n_azimuth=scan["n_azimuth"],
                            fov_deg=scan["fov_deg"],
                            seed=int(rng.integers(2 ** 63)))
        order = rng.permutation(calib.num_lasers).astype(np.int64)
        out.append(Frame(pc, order, int(rng.integers(2 ** 31))))
    return out


def ransac_draws(seed: int, trials: int) -> np.ndarray:
    """(trials, 3) float32 RANSAC uniforms from a CPU torch generator
    seeded `seed`: the draws the port makes for that seed."""
    import torch

    gen = torch.Generator().manual_seed(int(seed))
    return torch.rand((trials, 3), generator=gen).numpy()


def draws_seed(traffic: dict, run_seed: int, frame: Frame) -> int:
    """The seed of a frame's RANSAC draws under the traffic's "draws":
    "frame", each frame's own (the datagen's per-frame seed); "run", one
    for the whole run drawn from its seed (an augmenter's own seed)."""
    if traffic["draws"] == "frame":
        return frame.ransac_seed
    if traffic["draws"] == "run":
        return int(np.random.default_rng(
            [int(run_seed) & (2 ** 64 - 1), 0xA06]).integers(2 ** 31))
    raise ValueError(f"unknown draws {traffic['draws']!r}")
