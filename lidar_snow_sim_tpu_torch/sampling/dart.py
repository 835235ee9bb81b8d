"""Dart-throwing (rejection) sampling of non-overlapping snow-particle disks
(the port's copy of `lidar_snow_sim_tpu/sampling/dart.py`).

Two implementations of the reference's sampler (`tools/snowfall/sampling.py:90-194`):

- `dart_throwing`: literal semantics *and* literal RNG call order, so that with
  the same `np.random.Generator` seed it reproduces the reference's particle
  banks bit-for-bit. O(N^2) — use only for small occupancies / tests.

- `dart_throwing_fast`: identical accept/reject *criteria* (origin cover,
  exact pairwise disk overlap, stop at the first sample whose acceptance
  reaches the target area) but batched proposals + a uniform spatial hash for
  the overlap check. Statistically the same process, different RNG stream.
  ~1000x faster; used to generate production particle banks.

A native C++ sampler (see `native/`) implements the same fast algorithm for
bank-grid generation; `dart_throwing_fast` is the portable fallback.

Sampled geometry (per reference): particle centers uniform-in-area over a disk
of radius R_0; ball diameter ~ Exp(10/lambda) mm, rejected above 20 mm; center
height uniform in ±d/2; disk radius = radius of the ball/plane intersection.
"""

from __future__ import annotations

import numpy as np

from lidar_snow_sim_tpu_torch.sampling.distributions import diameter_rate_parameter

PI = np.pi


def dart_throwing(
    occupancy_ratio: float,
    precipitation_rate: float,
    R_0: float,
    rng: np.random.Generator,
    distribution: str = "sekhon",
) -> np.ndarray:
    """Literal-order rejection sampler. Returns (N, 3) [x, y, disk_radius]."""
    rate_param = diameter_rate_parameter(distribution, precipitation_rate)
    scale_mm = (1.0 / rate_param) * 10.0  # 1/cm → mean diameter in mm

    samples = np.zeros((0, 3))
    area_occupied = 0.0
    area_target = occupancy_ratio * PI * R_0**2

    while area_occupied < area_target:
        length = np.sqrt(rng.uniform(0, R_0**2))
        angle = rng.uniform(0, 2) * PI
        x = length * np.cos(angle)
        y = length * np.sin(angle)

        particle_diameter = np.inf
        while particle_diameter > 20:  # mm; cap at 2 cm
            particle_diameter = rng.exponential(scale_mm)
        particle_diameter = particle_diameter / 1000.0  # → m

        height = rng.uniform(-particle_diameter / 2, particle_diameter / 2)
        disk_radius = np.sqrt((particle_diameter / 2) ** 2 - height**2)

        if x**2 + y**2 <= disk_radius**2:  # disk covers the origin
            continue
        overlap = (samples[:, 0] - x) ** 2 + (samples[:, 1] - y) ** 2 <= (
            samples[:, 2] + disk_radius
        ) ** 2
        if np.any(overlap):
            continue

        area_occupied += PI * disk_radius**2
        samples = np.concatenate((samples, np.array([[x, y, disk_radius]])))

    return samples


def dart_throwing_fast(
    occupancy_ratio: float,
    precipitation_rate: float,
    R_0: float,
    rng: np.random.Generator,
    distribution: str = "sekhon",
    batch: int = 131072,
    max_diameter_mm: float = 20.0,
) -> np.ndarray:
    """Batched rejection sampler with a uniform spatial hash.

    The overlap predicate and stopping rule are exactly the reference's; only
    the proposal batching (and hence the RNG stream) differs.
    """
    rate_param = diameter_rate_parameter(distribution, precipitation_rate)
    scale_mm = (1.0 / rate_param) * 10.0
    area_target = occupancy_ratio * PI * R_0**2

    cell = max_diameter_mm / 1000.0  # max possible r_i + r_j
    inv_cell = 1.0 / cell
    # spatial hash: cell key -> list of accepted indices
    grid: dict[int, list[int]] = {}
    KEY = 1 << 21  # cells per axis stride for key packing

    xs = np.empty(0)
    ys = np.empty(0)
    rs = np.empty(0)
    n_acc = 0
    area = 0.0

    ax_buf = np.empty(1 << 22)
    ay_buf = np.empty(1 << 22)
    ar_buf = np.empty(1 << 22)

    while area < area_target:
        length = np.sqrt(rng.uniform(0, R_0**2, size=batch))
        angle = rng.uniform(0, 2, size=batch) * PI
        x = length * np.cos(angle)
        y = length * np.sin(angle)
        # truncated-exponential diameters (mm): redraw > cap, like the
        # reference's inner while loop
        d = rng.exponential(scale_mm, size=batch)
        over = d > max_diameter_mm
        while np.any(over):
            d[over] = rng.exponential(scale_mm, size=int(over.sum()))
            over = d > max_diameter_mm
        d = d / 1000.0
        h = rng.uniform(-d / 2, d / 2)
        r = np.sqrt((d / 2) ** 2 - h**2)

        ok = x**2 + y**2 > r**2  # origin-cover rejection
        x, y, r = x[ok], y[ok], r[ok]

        ix = np.floor((x + 2 * R_0) * inv_cell).astype(np.int64)
        iy = np.floor((y + 2 * R_0) * inv_cell).astype(np.int64)
        keys = ix * KEY + iy

        for i in range(len(x)):
            xi, yi, ri, ki = x[i], y[i], r[i], keys[i]
            hit = False
            for dk in (
                -KEY - 1, -KEY, -KEY + 1, -1, 0, 1, KEY - 1, KEY, KEY + 1
            ):
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
            ax_buf[n_acc] = xi
            ay_buf[n_acc] = yi
            ar_buf[n_acc] = ri
            grid.setdefault(int(ki), []).append(n_acc)
            n_acc += 1
            area += PI * ri * ri
            if area >= area_target:
                break

    return np.column_stack([ax_buf[:n_acc], ay_buf[:n_acc], ar_buf[:n_acc]])
