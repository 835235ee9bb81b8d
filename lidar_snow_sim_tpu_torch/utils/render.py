"""Headless visualization / debug-dump utilities (the port's copy of
`lidar_snow_sim_tpu/utils/render.py`).

The reference's interactive Qt viewer (`pointcloud_viewer.py`) is out of scope
here; its rendering capabilities are covered headlessly (SURVEY.md §7.6):

- ``bev_image``: bird's-eye-view raster of a scan colored by depth /
  intensity / label — replaces the per-point cv2 circle loop of
  `tools/wet_ground/utils.py:74-102` with a single vectorized splat.
- ``normalized_hist2d``: the column-normalized 2-D histogram behind
  `plot_2d_hist` (`tools/wet_ground/utils.py:12-30`), returned as arrays so it
  needs no display; feed to matplotlib if plotting is wanted.
- ``cloud_log_string``: the viewer's per-scan stats readout
  (`pointcloud_viewer.py:3122-3153`).
"""

from __future__ import annotations

import numpy as np

# label colors for the augmentation label column (0 unchanged / 1 attenuated /
# 2 scattered), loosely matching the viewer's color scheme
_LABEL_COLORS = np.array(
    [
        [180, 180, 180],  # 0: unchanged - gray
        [66, 135, 245],   # 1: attenuated / modified ground - blue
        [245, 66, 66],    # 2: scattered by particle - red
    ],
    dtype=np.uint8,
)


def _turbo_ish(values: np.ndarray) -> np.ndarray:
    """Cheap blue->green->red colormap over values in [0, 1], (N, 3) uint8."""
    v = np.clip(values, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * v - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * v - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * v - 1.0), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def bev_image(
    pointcloud: np.ndarray,
    map_size: tuple[float, float] = (80.0, 15.0),
    resolution: int = 10,
    color: str = "depth",
    splat: int = 1,
) -> np.ndarray:
    """Bird's-eye-view RGB raster (H, W, 3) uint8 of an (N, >=4) cloud.

    map_size is (x half-extent, y half-extent) in meters; resolution in
    pixels/m. color: 'depth' | 'intensity' | 'label'. splat grows each point
    to a (2*splat+1)^2 block.
    """
    w = int(2 * resolution * map_size[0])
    h = int(2 * resolution * map_size[1])
    img = np.zeros((h, w, 3), dtype=np.uint8)
    if len(pointcloud) == 0:
        return img

    x = (resolution * (pointcloud[:, 0] + map_size[0])).astype(np.int64)
    y = (resolution * (pointcloud[:, 1] + map_size[1])).astype(np.int64)

    if color == "depth":
        vals = np.linalg.norm(pointcloud[:, :3], axis=1) / 80.0
        colors = _turbo_ish(vals)
    elif color == "intensity":
        colors = _turbo_ish(pointcloud[:, 3] / 255.0)
    elif color == "channel":
        colors = _turbo_ish((pointcloud[:, 4] % 64.0) / 63.0)
    elif color == "height":
        colors = _turbo_ish((pointcloud[:, 2] + 2.5) / 5.0)
    elif color == "label":
        labels = np.clip(pointcloud[:, 4].astype(np.int64), 0, 2)
        colors = _LABEL_COLORS[labels]
    else:
        raise ValueError(f"unknown color mode {color!r}")

    for dy in range(-splat, splat + 1):
        for dx in range(-splat, splat + 1):
            xi = x + dx
            yi = y + dy
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            img[yi[ok], xi[ok]] = colors[ok]
    return img


def normalized_hist2d(var1, var2, bins_x: int = 100, bins_y: int = 100):
    """(hist, xedges, yedges): 2-D histogram with columns normalized to sum
    to a constant (the reference's norm=10), NaN-free."""
    hist, xedges, yedges = np.histogram2d(var1, var2, bins=(bins_x, bins_y))
    hist = hist.T
    col = hist.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        hist = np.where(col > 0, hist * 10.0 / col, 0.0)
    return hist, xedges, yedges


def particle_field_image(
    samples: np.ndarray,
    r0: float = 80.0,
    resolution: int = 8,
    radius_scale: float = 40.0,
) -> np.ndarray:
    """Raster of a sampled 2-D particle field (x, y, r rows) — the headless
    equivalent of the reference's bank debug SVGs
    (`tools/snowfall/sampling.py:280-320`). Particle size is exaggerated by
    radius_scale so sub-mm flakes are visible at map scale."""
    size = int(2 * r0 * resolution)
    img = np.zeros((size, size, 3), dtype=np.uint8)
    if len(samples) == 0:
        return img
    x = ((samples[:, 0] + r0) * resolution).astype(np.int64)
    y = ((samples[:, 1] + r0) * resolution).astype(np.int64)
    colors = _turbo_ish(
        np.log1p(samples[:, 2] * 1e3) / np.log1p(20.0)  # mm scale
    )
    splat = np.clip(
        (samples[:, 2] * radius_scale * resolution).astype(np.int64), 0, 3
    )
    for s in range(int(splat.max()) + 1):
        sel = splat >= s
        for dy in range(-s, s + 1):
            for dx in range(-s, s + 1):
                xi, yi = x[sel] + dx, y[sel] + dy
                ok = (xi >= 0) & (xi < size) & (yi >= 0) & (yi < size)
                img[yi[ok], xi[ok]] = colors[sel][ok]
    return img


def cloud_log_string(pc: np.ndarray) -> str:
    """Per-scan stats line: point count, max range, intensity summary."""
    if len(pc) == 0:
        return "0 points"
    r = np.linalg.norm(pc[:, :3], axis=1)
    i = pc[:, 3]
    return (
        f"{len(pc):,} points | max dist {r.max():.1f} m | intensity "
        f"min {i.min():.0f} max {i.max():.0f} median {np.median(i):.0f} "
        f"mean {i.mean():.1f} std {i.std():.1f}"
    )


def augmentation_stat_labels(pc_labeled: np.ndarray, n_before: int) -> dict:
    """The viewer's stat-label counters (`pointcloud_viewer.py:2823-2830`)."""
    labels = pc_labeled[:, 4]
    return {
        "num_unchanged": int((labels == 0).sum()),
        "num_attenuated": int((labels == 1).sum()),
        "num_scattered": int((labels == 2).sum()),
        "num_removed": int(n_before - len(pc_labeled)),
    }
