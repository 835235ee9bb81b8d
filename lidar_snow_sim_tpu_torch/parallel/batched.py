"""Batched augmentation steps (counterpart of
`lidar_snow_sim_tpu/parallel/batched.py`).

A step is the offline-datagen unit: snowfall, optionally chained with wet
ground (the viewer's snow+wet mode, `pointcloud_viewer.py:2804-2840`), over
a frame batch. `batched_step` and `datagen_packed_step` run one batched
core: each frame's preamble and phase-A layout; phase A folded into one A1
launch over the batch when `batch_fold` is set and every frame's kernel is
A1 (the JAX package's fold rule, pallas_occluders.py:1080-1128), else one
launch per frame; then each frame's phases B, C and D, and wet ground. A
window config (`assembly="window"`) runs `snowfall_augment` frame by frame
(kernels W1 and W2 once a frame on the card), each frame's rows
stable-sorted by channel with the padding last, as the JAX `batched_step`
gives them. The packed in/out surface is the JAX package's.

`make_sharded_step` and `make_sharded_packed_step` split a batch's frames
over a `parallel/mesh.Mesh` and run each shard through the same step on
its device (`parallel/mesh.run_shards`), with the kernels on whatever
the mesh's shape (see `parallel/mesh.py` for why the 'beam' axis shards
frames too). The outputs are the unsharded step's, byte for byte.
"""

from __future__ import annotations

import torch

from lidar_snow_sim_tpu_torch.config import SnowfallConfig, WetGroundConfig
from lidar_snow_sim_tpu_torch.models.snowfall import (
    SnowfallResult,
    dense_layout,
    finish_scan,
    run_phase_a,
    run_phase_a_folded,
    snowfall_augment,
)
from lidar_snow_sim_tpu_torch.models.wet_ground import (
    WetGroundResult,
    wet_ground_augment,
)
from lidar_snow_sim_tpu_torch.ops.fitting import ransac_draws
from lidar_snow_sim_tpu_torch.parallel.mesh import (
    Mesh,
    gather_frames,
    run_shards,
)
from lidar_snow_sim_tpu_torch.utils.profiling import span

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


def _batched_core(points, mask, bank, calib, orders, snow_draws, wet_draws,
                  snow_cfg: SnowfallConfig, wet_cfg: WetGroundConfig | None):
    """B frames through snowfall and, with a `wet_cfg`, wet ground on the
    snowfall output (replace=False keeps the snow labels). points (B, N, 5),
    mask (B, N), orders (B, C) and the draws are indexed by frame. Returns
    (B SnowfallResults, B WetGroundResults or None)."""
    with span("batched.core"):
        frames = range(points.shape[0])
        if snow_cfg.assembly == "dense":
            lays = [dense_layout(points[b], mask[b], bank, orders[b],
                                 snow_draws[b], snow_cfg, frame=b)
                    for b in frames]
            if snow_cfg.batch_fold and all(lay.kernel == "A1"
                                           for lay in lays):
                phase_a = run_phase_a_folded(lays)
            else:
                phase_a = [run_phase_a(lay, frame=b)
                           for b, lay in zip(frames, lays)]
            snows = [finish_scan(lay, *pa, calib, snow_cfg, frame=b)
                     for b, lay, pa in zip(frames, lays, phase_a)]
        else:
            snows = [snowfall_augment(points[b], mask[b], bank, calib,
                                      orders[b], snow_draws[b], snow_cfg)
                     for b in frames]
        if wet_cfg is None:
            return snows, None
        return snows, [wet_ground_augment(s.planes, s.keep, wet_draws[b],
                                          wet_cfg)
                       for b, s in zip(frames, snows)]


def _stack(results, cls):
    return cls(*(torch.stack(f) for f in zip(*results)))


def batched_step(points, mask, bank, calib, orders, draws,
                 snow_cfg: SnowfallConfig,
                 wet_cfg: WetGroundConfig | None = None):
    """The JAX package's `batched_step` on the port: B frames in, a
    batched SnowfallResult (every field with a leading frame axis) and,
    with a `wet_cfg`, a batched WetGroundResult (else None) out.

    points (B, N, 5) f32 and mask (B, N) bool padded scans; bank and calib
    from `bank_to_torch` / `calib_to_torch`; orders (B, C) int64 channel ->
    bank-row permutations; draws a pair (snow, wet) of RANSAC draws, each
    (B, ransac_trials, 3) f32, wet None without a `wet_cfg` (where the JAX
    package takes one PRNG key per frame).
    """
    snow_draws, wet_draws = draws
    snows, wets = _batched_core(points, mask, bank, calib, orders,
                                snow_draws, wet_draws, snow_cfg, wet_cfg)
    return (_stack(snows, SnowfallResult),
            None if wets is None else _stack(wets, WetGroundResult))


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
    with span("batched.step"):
        return _packed_step(points, chan, in_meta, bank, calib, snow_cfg,
                            wet_cfg, out_points)


def _packed_step(points, chan, in_meta, bank, calib, snow_cfg, wet_cfg,
                 out_points):
    n = points.shape[1]
    p_out = out_points or n
    dev = points.device
    with span("batched.draws"):
        meta = torch.as_tensor(in_meta).cpu()
        pts = torch.cat([points, chan.to(torch.float32)[..., None]], dim=2)
        mask = torch.arange(n, device=dev)[None, :] < meta[:, :1].to(dev)
        draws = [frame_draws(
            ((int(m[1]) & 0xFFFFFFFF) << 32) | (int(m[2]) & 0xFFFFFFFF),
            snow_cfg, wet_cfg,
        ) for m in meta]
        orders = meta[:, 3:].to(torch.int64).to(dev)
        snow_draws = [d[0].to(dev) for d in draws]
        wet_draws = (None if wet_cfg is None
                     else [d[1].to(dev) for d in draws])
    snows, wets = _batched_core(pts, mask, bank, calib, orders, snow_draws,
                                wet_draws, snow_cfg, wet_cfg)
    with span("batched.pack_out"):
        planes_out, metas = [], []
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        for b, snow in enumerate(snows):
            wet = None if wets is None else wets[b]
            res = wet if wet is not None else snow
            perm = torch.argsort((~res.keep).to(torch.int8),
                                 stable=True)[:p_out]
            planes_c = res.planes[:, perm]
            n_keep = res.keep.sum().to(torch.int32)
            if wet_cfg is None:
                packed = (
                    (torch.round(planes_c[3]).to(torch.int32) << 2)
                    | planes_c[4].to(torch.int32)
                ).view(torch.float32)
                planes_c = torch.cat([planes_c[:3], packed[None]], dim=0)
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


class _Replicas:
    """Each (bank or calib, device) pair copied once: the copies are kept
    for as long as the step that made them."""

    def __init__(self):
        self._copies = {}

    def __call__(self, obj, device):
        key = (id(obj), str(device))
        if key not in self._copies:
            self._copies[key] = (obj, obj.to(device))
        return self._copies[key][1]


def make_sharded_step(mesh: Mesh, snow_cfg: SnowfallConfig,
                      wet_cfg: WetGroundConfig | None = None):
    """`batched_step` with its frames sharded over `mesh` (the JAX
    package's `make_sharded_step`). Returns step(points, mask, bank, calib,
    orders, draws) with `batched_step`'s arguments and results: each shard
    runs `batched_step` on its device, bank and calib copied there once,
    and the results come back in frame order on the points' device."""
    replicas = _Replicas()

    def step(points, mask, bank, calib, orders, draws):
        snow_draws, wet_draws = draws

        def shard(dev, f):
            return batched_step(
                points[f].to(dev), mask[f].to(dev), replicas(bank, dev),
                replicas(calib, dev), orders[f].to(dev),
                (snow_draws[f].to(dev),
                 None if wet_draws is None else wet_draws[f].to(dev)),
                snow_cfg, wet_cfg)

        parts = run_shards(mesh, points.shape[0], shard)
        out = points.device
        return (gather_frames([p[0] for p in parts], out),
                None if wet_cfg is None
                else gather_frames([p[1] for p in parts], out))

    return step


def make_sharded_packed_step(mesh: Mesh, snow_cfg: SnowfallConfig,
                             wet_cfg: WetGroundConfig | None = None,
                             out_points: int | None = None):
    """`datagen_packed_step` with its frames sharded over `mesh` (the JAX
    package's `make_sharded_packed_step`). Returns step(points, chan,
    in_meta, bank, calib) -> (planes_c, out_meta) in frame order on the
    points' device, `datagen_packed_step`'s results byte for byte."""
    replicas = _Replicas()

    def step(points, chan, in_meta, bank, calib):
        def shard(dev, f):
            return datagen_packed_step(
                points[f].to(dev), chan[f].to(dev), in_meta[f],
                replicas(bank, dev), replicas(calib, dev), snow_cfg,
                wet_cfg=wet_cfg, out_points=out_points)

        parts = run_shards(mesh, points.shape[0], shard)
        return gather_frames(parts, points.device)

    return step
