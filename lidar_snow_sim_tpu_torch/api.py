"""Reference-compatible API (counterpart of `lidar_snow_sim_tpu/api.py`).

`augment` and `ground_water_augmentation` keep the reference's argument
names, defaults and return contracts (`tools/snowfall/simulation.py:427-446`,
`tools/wet_ground/augmentation.py:25-41`); the particle files are the
reference's `{prefix}_{line}.npy`. Both take one extra keyword, `device`
(default "cuda"; without a card it raises, and the CPU must be asked
for with device="cpu"); `augment` also takes `config`, a dict
of SnowfallConfig fields set over its defaults (for example route_band=384,
band_group=16 for the span-routed phase A). Loaded banks and augmenters are
cached per (prefix, config, device).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from lidar_snow_sim_tpu_torch.calib import load_hdl64_calib
from lidar_snow_sim_tpu_torch.camera import camera_fov_mask
from lidar_snow_sim_tpu_torch.config import SnowfallConfig, WetGroundConfig
from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.models.snowfall import SnowfallAugmenter
from lidar_snow_sim_tpu_torch.models.wet_ground import WetGroundAugmenter
from lidar_snow_sim_tpu_torch.sampling.banks import load_bank_files

_AUGMENTER_CACHE: dict = {}
_WET_CACHE: dict = {}


def _next_pow2(n: int, floor: int = 2048) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def augment(
    pc: np.ndarray,
    particle_file_prefix: str,
    beam_divergence: float,
    shuffle: bool = True,
    show_progressbar: bool = False,
    only_camera_fov: bool = True,
    noise_floor: float = 0.7,
    root_path: str | None = None,
    device="cuda",
    config: dict | None = None,
):
    """Snowfall augmentation with the reference's signature and semantics.

    Returns ((num_attenuated, num_removed, avg_intensity_diff), aug_pc):
    the reference's stats tuple and N-by-5 cloud with the 0/1/2 label
    column. beam_divergence is in degrees; show_progressbar is ignored.
    """
    del show_progressbar
    dev = resolve_device(device)
    pc = np.asarray(pc)
    directory = Path(root_path) if root_path else Path(
        os.environ.get("SNOWFLAKES_DIR", "snowflakes")
    )
    cap = _next_pow2(len(pc))
    overrides = dict(config or {})
    key = (str(directory), particle_file_prefix, beam_divergence,
           noise_floor, cap, str(dev), tuple(sorted(overrides.items())))
    if key not in _AUGMENTER_CACHE:
        pch = max(cap // 64, 256)
        cfg = SnowfallConfig(**{
            **dict(
                beam_divergence_deg=beam_divergence,
                noise_floor=noise_floor,
                max_points=cap,
                assembly="dense",
                channel_capacity=pch,
                block_points=max(min(128, pch // 8), 32),
            ),
            **overrides,
        })
        bank = load_bank_files(
            directory, particle_file_prefix,
            window_size=cfg.window_size,
            wide_threshold=cfg.wide_threshold,
            wide_capacity=cfg.wide_capacity,
        )
        _AUGMENTER_CACHE[key] = SnowfallAugmenter(
            bank=bank, calib=load_hdl64_calib(), cfg=cfg, device=dev
        )
    stats, aug_pc = _AUGMENTER_CACHE[key](pc, shuffle=shuffle)
    if only_camera_fov:
        # reference order (simulation.py:532-540): augment the full cloud,
        # crop to the camera FOV at the end, count the cropped points as
        # removed; num_attenuated and avg_intensity_diff stay pre-crop
        fov = camera_fov_mask(aug_pc[:, :3]).numpy()
        num_attenuated, num_removed, avg_intensity_diff = stats
        stats = (num_attenuated, num_removed + int((~fov).sum()),
                 avg_intensity_diff)
        aug_pc = aug_pc[fov]
    return stats, aug_pc


def ground_water_augmentation(
    pointcloud: np.ndarray,
    water_height: float = 0.001,
    pavement_depth: float = 0.0012,
    noise_floor: float = 0.7,
    power_factor: float = 15,
    estimation_method: str = "linear",
    flat_earth: bool = False,
    debug: bool = False,
    delta: float = 0.5,
    replace: bool = True,
    device="cuda",
):
    """Wet-ground augmentation with the reference's signature; returns the
    augmented N-by-5 cloud (augmentation.py:25-161). debug is ignored."""
    del debug
    dev = resolve_device(device)
    pointcloud = np.asarray(pointcloud)
    cap = _next_pow2(len(pointcloud))
    cfg = WetGroundConfig(
        water_height=water_height,
        pavement_depth=pavement_depth,
        noise_floor=noise_floor,
        power_factor=power_factor,
        estimation_method=estimation_method,
        flat_earth=flat_earth,
        delta=delta,
        replace=replace,
    )
    key = (cfg, cap, str(dev))
    if key not in _WET_CACHE:
        _WET_CACHE[key] = WetGroundAugmenter(cfg=cfg, max_points=cap,
                                             device=dev)
    return _WET_CACHE[key](pointcloud)
