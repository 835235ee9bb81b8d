"""Synthetic HDL-64-like scan generation (the port's copy of
`lidar_snow_sim_tpu/utils/synthetic.py`).

Used by tests and benchmarks when the STF/DENSE dataset is not on disk. The
scene is a near-flat ground plane ~1.7 m below the sensor — dipping under the
nominal -1.55 m DENSE mounting height so the reference's ground crop
(z < -1.55, `tools/wet_ground/planes.py:21-26`) actually populates — plus a
few box obstacles,
ray-cast per (channel, azimuth) with a distance-decaying intensity model so the
reference's laser-parameter estimators (linear power fit + histogram noise
floor) produce sensible values.
"""

from __future__ import annotations

import numpy as np

from lidar_snow_sim_tpu_torch.calib import SensorCalib, load_hdl64_calib


def synthetic_scan(
    n_azimuth: int = 870,
    fov_deg: float = 87.0,
    sensor_height: float = 1.75,
    max_range: float = 80.0,
    seed: int = 0,
    calib: SensorCalib | None = None,
    n_boxes: int = 12,
) -> np.ndarray:
    """Generate an (N, 5) float32 scan (x, y, z, intensity, channel).

    Azimuths span the forward camera FOV (centered on +x) to mimic the
    FOV-filtered scans the reference's offline datagen feeds to augment()
    (`tools/snowfall/precompute.py:96-99`).
    """
    calib = calib or load_hdl64_calib()
    rng = np.random.default_rng(seed)
    n_ch = calib.num_lasers

    az = np.radians(np.linspace(-fov_deg / 2, fov_deg / 2, n_azimuth))
    elev = calib.vert_correction  # radians, negative = downward
    az_g, el_g = np.meshgrid(az, elev)  # (n_ch, n_az)
    ch_g = np.broadcast_to(np.arange(n_ch)[:, None], az_g.shape)

    dir_x = np.cos(el_g) * np.cos(az_g)
    dir_y = np.cos(el_g) * np.sin(az_g)
    dir_z = np.sin(el_g)

    # Ground-plane hit with a mild random road grade and cm-level roughness
    # (a perfect plane would make the RANSAC MAD threshold degenerate).
    # grade kept small enough that the reference ground crop (z < -1.55,
    # planes.py:21) stays populated out to ~70 m with the 1.75 m mounting
    slope_x = rng.uniform(-0.003, 0.003)
    slope_y = rng.uniform(-0.002, 0.002)
    denom = dir_z - slope_x * dir_x - slope_y * dir_y
    t_ground = np.where(denom < -1e-4, -sensor_height / denom, np.inf)
    rough = rng.normal(0.0, 0.02, size=t_ground.shape)
    t_ground = t_ground * (1.0 + np.where(np.isfinite(t_ground), rough / 80.0, 0.0))
    t_ground = t_ground + np.where(np.isfinite(t_ground), rough, 0.0)

    # Box obstacles: axis-aligned, random positions in front of the sensor.
    t_hit = t_ground.copy()
    refl = np.full(az_g.shape, 0.12)  # asphalt-ish ground reflectivity
    for _ in range(n_boxes):
        bx = rng.uniform(8, 60)
        # obstacles sit off the driving corridor (|y| > 4.5 m) so the
        # reference's in-trajectory ground crop (|y| < 3, planes.py:24)
        # keeps a clear line of sight, as on a real drivable road
        by = rng.uniform(4.5, 15.0) * rng.choice((-1.0, 1.0))
        bw, bl, bh = rng.uniform(1, 4, size=3) * np.array([1, 1.5, 1.0])
        box_refl = rng.uniform(0.2, 0.9)
        # slab intersection with vertical box [bx±bw, by±bl, -1.55..-1.55+bh]
        with np.errstate(divide="ignore", invalid="ignore"):
            tx0 = (bx - bw) / dir_x
            tx1 = (bx + bw) / dir_x
            ty0 = np.where(np.abs(dir_y) > 1e-9, (by - bl) / dir_y, -np.inf)
            ty1 = np.where(np.abs(dir_y) > 1e-9, (by + bl) / dir_y, np.inf)
        t_near = np.maximum(np.minimum(tx0, tx1), np.minimum(ty0, ty1))
        t_far = np.minimum(np.maximum(tx0, tx1), np.maximum(ty0, ty1))
        z_at = t_near * dir_z
        hits = (
            (t_near > 0.5)
            & (t_near < t_far)
            & (z_at > -sensor_height)
            & (z_at < -sensor_height + bh)
            & (t_near < t_hit)
        )
        refl = np.where(hits, box_refl, refl)
        t_hit = np.where(hits, t_near, t_hit)

    valid = np.isfinite(t_hit) & (t_hit > 1.0) & (t_hit < max_range)
    t = np.where(valid, t_hit, 1.0)
    x = (t * dir_x)[valid]
    y = (t * dir_y)[valid]
    z = (t * dir_z)[valid]
    d = t[valid]
    r = refl[valid]
    ch = ch_g[valid].astype(np.float32)

    # Intensity model: received ~ emitted(d) * cos(incident) * reflectivity.
    # Emitted power rises mildly with distance (the reference fits a *linear*
    # relative-output-power-vs-distance model, augmentation.py:216-221).
    cos_inc = np.where(r < 0.15, sensor_height / np.maximum(d, 1e-3), 0.9)
    cos_inc = np.clip(cos_inc, 0.02, 1.0)
    emitted = 40.0 + 2.2 * d
    intensity = emitted * cos_inc * (r / 0.12)
    intensity += rng.normal(0, 2.0, size=intensity.shape)
    intensity = np.clip(np.round(intensity), 0, 255)

    pc = np.column_stack([x, y, z, intensity, ch]).astype(np.float32)
    # Drop a random subset to make the scan ragged like real data.
    keep = rng.uniform(size=len(pc)) > 0.05
    return pc[keep]
