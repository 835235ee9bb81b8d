"""Batched augmentation steps (counterpart of
`lidar_snow_sim_tpu/parallel/batched.py`).

A step is the offline-datagen unit: snowfall, optionally chained with wet
ground (the viewer's snow+wet mode, `pointcloud_viewer.py:2804-2840`), over
a frame batch. The frames run one after another through the single-scan
path; the packed in/out surface is the JAX package's.
"""

from __future__ import annotations

import torch

from lidar_snow_sim_tpu.config import SnowfallConfig, WetGroundConfig
from lidar_snow_sim_tpu_torch.models.snowfall import snowfall_augment_dense
from lidar_snow_sim_tpu_torch.models.wet_ground import wet_ground_augment
from lidar_snow_sim_tpu_torch.ops.fitting import ransac_draws

IN_META_WIDTH = 3 + 64   # [n_points, seed_hi, seed_lo, order(64)]
OUT_META_WIDTH = 13      # [n_keep, att, rem, avg_diff, 5 overflows,
#                           out_overflow, wet_modified, wet_removed,
#                           wet_bailed]


def frame_draws(seed: int, snow_cfg: SnowfallConfig,
                wet_cfg: WetGroundConfig | None):
    """One frame's RANSAC draws: snowfall's, then wet ground's, from one CPU
    generator seeded `seed`."""
    gen = torch.Generator().manual_seed(int(seed))
    snow = ransac_draws(seed, snow_cfg.ransac_trials, gen)
    wet = None if wet_cfg is None else ransac_draws(
        seed, wet_cfg.ransac_trials, gen
    )
    return snow, wet


def snow_wet_step(points, mask, bank, calib, order, snow_draws, wet_draws,
                  snow_cfg: SnowfallConfig, wet_cfg: WetGroundConfig | None):
    """One scan through snowfall and, with a `wet_cfg`, wet ground on the
    snowfall output (replace=False keeps the snow labels). Returns
    (SnowfallResult, WetGroundResult or None)."""
    snow = snowfall_augment_dense(
        points, mask, bank, calib, order, snow_draws, snow_cfg
    )
    if wet_cfg is None:
        return snow, None
    return snow, wet_ground_augment(snow.planes, snow.keep, wet_draws,
                                    wet_cfg)


def datagen_packed_step(points, chan, in_meta, bank, calib,
                        snow_cfg: SnowfallConfig,
                        wet_cfg: WetGroundConfig | None = None,
                        out_points: int | None = None):
    """`run_snowfall_datagen`'s batched step on the JAX package's surface.

    In: points (B, N, 4) f32 [x, y, z, intensity] and chan (B, N) uint8 on
    the device; in_meta (B, 3 + C) int32 rows [n_points, seed_hi, seed_lo,
    order(C)], where (seed_hi << 32) | seed_lo seeds the frame's RANSAC
    draws. Kept rows are compacted to the front (the row order of a
    boolean filter) and `out_points` rows return. Snowfall-only runs pack
    intensity and label into one int32 plane (round(i) << 2 | label,
    bitcast to f32): 4 output rows; wet runs return 5.

    Returns (planes_c (B, 4|5, P) f32, out_meta (B, 13) int32):
    out_meta = [n_keep, num_attenuated, num_removed, avg_intensity_diff,
    window/occluder/bump/channel/compact overflow, out_overflow
    (max(n_keep - P, 0)), wet_modified, wet_removed, wet_bailed].
    """
    n = points.shape[1]
    p_out = out_points or n
    dev = points.device
    meta = torch.as_tensor(in_meta).cpu()
    planes_out, metas = [], []
    for b in range(points.shape[0]):
        n_pts, seed_hi, seed_lo = (int(v) & 0xFFFFFFFF for v in meta[b, :3])
        pts = torch.cat([points[b], chan[b].to(torch.float32)[:, None]], 1)
        mask = torch.arange(n, device=dev) < n_pts
        snow_draws, wet_draws = frame_draws(
            (seed_hi << 32) | seed_lo, snow_cfg, wet_cfg
        )
        snow, wet = snow_wet_step(
            pts, mask, bank, calib, meta[b, 3:].to(torch.int64).to(dev),
            snow_draws.to(dev),
            None if wet_draws is None else wet_draws.to(dev),
            snow_cfg, wet_cfg,
        )
        res = wet if wet is not None else snow
        perm = torch.argsort((~res.keep).to(torch.int8), stable=True)[:p_out]
        planes_c = res.planes[:, perm]
        n_keep = res.keep.sum().to(torch.int32)
        if wet_cfg is None:
            packed = (
                (torch.round(planes_c[3]).to(torch.int32) << 2)
                | planes_c[4].to(torch.int32)
            ).view(torch.float32)
            planes_c = torch.cat([planes_c[:3], packed[None]], dim=0)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        metas.append(torch.stack([
            n_keep,
            snow.num_attenuated,
            snow.num_removed,
            snow.avg_intensity_diff,
            snow.window_overflow,
            snow.occluder_overflow,
            snow.bump_overflow,
            snow.channel_overflow,
            snow.compact_overflow,
            (n_keep - p_out).clamp_min(0),
            zero if wet is None else wet.num_modified,
            zero if wet is None else wet.num_removed,
            zero if wet is None else wet.bailed_out.to(torch.int32),
        ]))
        planes_out.append(planes_c)
    return torch.stack(planes_out), torch.stack(metas)
