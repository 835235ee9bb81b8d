"""Wet-ground reflectance augmentation on tensors (counterpart of
`lidar_snow_sim_tpu/models/wet_ground.py`; reference
`tools/wet_ground/augmentation.py:25-161`).

RANSAC ground plane (draws injected), incident angles, laser power and
adaptive noise, per-point reflectivity, two-interface Fresnel
transmittance, water-fill blending and the adaptive-threshold drop rule.
Fewer than `min_ground_points` ground points leave the scan unchanged
(augmentation.py:51-52). The host wrapper reproduces the reference's output
order: non-ground points first, surviving ground points appended.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.config import WetGroundConfig
from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.utils.pointcloud import pad_cloud
from lidar_snow_sim_tpu_torch.ops.fitting import ransac_draws, ransac_plane
from lidar_snow_sim_tpu_torch.ops.fresnel import (
    total_transmittance_from_ground,
)
from lidar_snow_sim_tpu_torch.ops.geometry import norm3
from lidar_snow_sim_tpu_torch.ops.laser import estimate_laser_parameters


class WetGroundResult(NamedTuple):
    planes: torch.Tensor      # (5, N) rows x, y, z, intensity, label
    keep: torch.Tensor        # (N,) bool
    is_ground: torch.Tensor   # (N,) bool
    bailed_out: torch.Tensor  # bool: too few ground points, input unchanged
    num_modified: torch.Tensor  # int32: surviving ground points
    num_removed: torch.Tensor   # int32: ground points dropped


def wet_ground_augment(planes, mask, draws, cfg: WetGroundConfig,
                       plane=None) -> WetGroundResult:
    """Wet-ground augmentation of a padded (5, N) plane-major scan (rows x,
    y, z, intensity, label). `draws` are the (trials, 3) RANSAC uniforms,
    unused when `plane` = (w, h) is given."""
    xyz = planes[:3].T
    intensity = planes[3]
    if plane is None:
        w, h = ransac_plane(xyz, mask, draws)
    else:
        w, h = plane

    hog = xyz @ w
    ground = mask & ((hog + h) < cfg.delta) & ((hog + h) > -cfg.delta)
    n_ground = ground.sum()
    bail = n_ground < cfg.min_ground_points

    dist = norm3(xyz)
    if cfg.flat_earth:
        cos_arg = -xyz[:, 2] / dist.clamp_min(1e-12)
    else:
        cos_arg = (xyz @ w) / (
            dist.clamp_min(1e-12) * torch.linalg.vector_norm(w)
        )
    incident = torch.arccos(torch.clamp(cos_arg, -1.0, 1.0))

    relative_output, threshold = estimate_laser_parameters(
        xyz, intensity, incident, ground,
        power_factor=cfg.power_factor,
        noise_floor=cfg.noise_floor,
        estimation_method=cfg.estimation_method,
    )
    cos_inc = torch.cos(incident)
    reflectivities = intensity / cos_inc / relative_output
    _, ts, _, tp, _ = total_transmittance_from_ground(
        incident, nair=cfg.n_air, nw=cfg.n_water,
        rho=torch.clamp(reflectivities, cfg.min_reflectivity, 1.0),
    )
    t = torch.maximum(tp, ts)

    # clear vs wet reflection blend; 45-degree thread profile assumption
    f = float(np.clip(cfg.water_height / cfg.pavement_depth, 0.0, 1.0))
    tw = (1 - f) * reflectivities + f * t / incident

    new_int = torch.minimum(
        torch.clamp(relative_output * cos_inc * tw, min=0.0), intensity
    )
    gate = threshold * cos_inc
    new_int = torch.where(new_int < gate, 0.0, new_int)
    ground_keep = new_int > gate

    out_intensity = torch.where(ground & ~bail, new_int, intensity)
    # replace=True zeroes every label before marking ground
    non_ground_label = 0.0 if cfg.replace else planes[4]
    label = torch.where(ground & ~bail, 1.0, non_ground_label)

    keep = torch.where(bail, mask, mask & (~ground | ground_keep))
    out = torch.stack([
        planes[0], planes[1], planes[2],
        torch.where(bail, intensity, out_intensity),
        torch.where(bail, planes[4], label),
    ])
    return WetGroundResult(
        planes=out,
        keep=keep,
        is_ground=ground & ~bail,
        bailed_out=bail,
        num_modified=(ground & ground_keep & ~bail).sum().to(torch.int32),
        num_removed=(ground & ~ground_keep & ~bail).sum().to(torch.int32),
    )


def filter_below_ground(pointcloud, w, h, margin: float = 0.5):
    """Keep rows with w . p + h < margin, the reference's pre-filter
    (augmentation.py:164-168)."""
    pc = np.asarray(pointcloud)
    return pc[pc[:, :3] @ np.asarray(w) + h < margin]


@dataclasses.dataclass
class WetGroundAugmenter:
    """Host wrapper with the reference's `ground_water_augmentation(pc) ->
    aug_pc` contract and output order. RANSAC draws come from a CPU
    generator seeded `seed`."""

    cfg: WetGroundConfig = WetGroundConfig()
    max_points: int = 32768
    seed: int = 0
    device: str | torch.device = "cuda"

    def __call__(self, pc, plane=None):
        dev = resolve_device(self.device)
        padded = pad_cloud(np.asarray(pc), self.max_points)
        if plane is not None:
            plane = (torch.as_tensor(plane[0], dtype=torch.float32,
                                     device=dev),
                     torch.tensor(float(plane[1]), device=dev))
        res = wet_ground_augment(
            torch.as_tensor(np.ascontiguousarray(padded.points.T),
                            device=dev),
            torch.as_tensor(padded.mask, device=dev),
            ransac_draws(self.seed, self.cfg.ransac_trials).to(dev),
            self.cfg,
            plane=plane,
        )
        if bool(res.bailed_out):
            return np.asarray(pc)
        n = len(pc)
        pts = res.planes.T[:n].cpu().numpy()
        keep = res.keep[:n].cpu().numpy()
        is_g = res.is_ground[:n].cpu().numpy()
        return np.concatenate([pts[~is_g & keep], pts[is_g & keep]], axis=0)
