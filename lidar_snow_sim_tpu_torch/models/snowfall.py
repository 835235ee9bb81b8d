"""Snowfall augmentation, dense assembly (counterpart of
`lidar_snow_sim_tpu/models/snowfall.py`, `snowfall_augment_dense` on its
Pallas branch).

Per scan:

1. ground plane (RANSAC, draws injected) -> incident angles -> adaptive
   noise polynomial over range (simulation.py:449-469);
2. layout: points stable-sorted by (channel, signed azimuth); chunks are
   `block_points`-wide windows of that order, starts aligned down to a
   block, one spill window per channel, and a `has` gate for windows with
   no in-channel point. Each chunk reads one bank slice of slice_width +
   128 columns, its start aligned down to 128, from the bank's azimuth LUT;
3. phase A: kernel A1 (`ops/occluders.py`), the nearest K occluders of
   every beam;
4. phase B: the occluded beams compacted, keyed (occluder count, slot);
5. phase C: kernel C1 (`ops/pulse.py`), sweep and pulse peak, then the
   label/intensity decision tail in torch;
6. phase D: the touched beams scattered back to the original order.

The slice geometry, and so every overflow counter, is the JAX Pallas
branch's, so the counters of the two packages can be compared. Where a
bank row is shorter than the widened slice (the JAX package then takes its
XLA branch) the port keeps this layout and clips the slice to the row.

Configuration knobs that only choose between bit-identical TPU layouts are
ignored: pallas_pair, pallas_transposed, pulse_pair, batch_fold,
pulse_block, use_pallas, pallas_interpret and chunk_group. The device
decides instead: a CUDA tensor goes to the kernels, a CPU tensor to their
plain versions. `route_band > 0` and `band_width > 0` (kernels A2 and A3)
and `assembly="window"` raise NotImplementedError (ROADMAP.md, Open items).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import NamedTuple

import numpy as np
import torch

from lidar_snow_sim_tpu.calib import SensorCalib
from lidar_snow_sim_tpu.config import SPEED_OF_LIGHT, SnowfallConfig
from lidar_snow_sim_tpu.sampling.banks import (
    LUT_BINS,
    LUT_HI,
    LUT_LO,
    ParticleBank,
)
from lidar_snow_sim_tpu.utils.pointcloud import pad_cloud
from lidar_snow_sim_tpu_torch.ops.f32 import div
from lidar_snow_sim_tpu_torch.ops.fitting import (
    masked_polyfit2,
    polyval2,
    ransac_draws,
    ransac_plane,
)
from lidar_snow_sim_tpu_torch.ops.geometry import beam_limits, norm3
from lidar_snow_sim_tpu_torch.ops.laser import estimate_laser_parameters
from lidar_snow_sim_tpu_torch.ops.occluders import (
    find_occluders,
    point_features,
)
from lidar_snow_sim_tpu_torch.ops.pulse import pulse_peaks

logger = logging.getLogger(__name__)

_I32_MAX = 2**31 - 1
OVERFLOW_COUNTERS = (
    "window_overflow",
    "occluder_overflow",
    "bump_overflow",
    "channel_overflow",
    "compact_overflow",
)


class SnowfallResult(NamedTuple):
    planes: torch.Tensor           # (5, N) rows x, y, z, intensity, label
    keep: torch.Tensor             # (N,) bool: survives noise floor
    num_attenuated: torch.Tensor   # int32
    num_removed: torch.Tensor      # int32
    avg_intensity_diff: torch.Tensor  # int32, truncated toward zero
    window_overflow: torch.Tensor  # bank columns a slice failed to cover
    occluder_overflow: torch.Tensor  # hits beyond max_occluders
    bump_overflow: torch.Tensor    # always 0: bumps == occluders here
    channel_overflow: torch.Tensor  # points beyond channel_capacity
    compact_overflow: torch.Tensor  # occluded beyond compact_capacity,
    # plus touched/moved beyond touch_capacity/scatter_capacity


class BankTensors(NamedTuple):
    """The ParticleBank arrays the dense assembly reads, on one device."""

    data_t: torch.Tensor   # (C, 8, K_ext) f32 property rows
    wide_t: torch.Tensor   # (C, 8, Wc) f32
    count: torch.Tensor    # (C,) int32 narrow count
    lut: torch.Tensor      # (C, LUT_BINS + 1) int64 azimuth -> column


class CalibTensors(NamedTuple):
    min_intensity: torch.Tensor
    focal_distance: torch.Tensor
    focal_slope: torch.Tensor
    focal_offset: torch.Tensor
    max_intensity: torch.Tensor


def bank_to_torch(bank: ParticleBank, device) -> BankTensors:
    return BankTensors(
        data_t=torch.as_tensor(bank.data_t, dtype=torch.float32,
                               device=device).contiguous(),
        wide_t=torch.as_tensor(bank.wide_t, dtype=torch.float32,
                               device=device).contiguous(),
        count=torch.as_tensor(bank.count, dtype=torch.int32, device=device),
        lut=torch.as_tensor(bank.lut, dtype=torch.int64, device=device),
    )


def calib_to_torch(calib: SensorCalib, device) -> CalibTensors:
    return CalibTensors(*(
        torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
        for a in (calib.min_intensity, calib.focal_distance,
                  calib.focal_slope, calib.focal_offset,
                  calib.max_intensity)
    ))


def _cap_from_slots(n2: int, pulse_chunk: int) -> int:
    """A quarter of the slots, rounded up to a pulse_chunk multiple."""
    return -(-max(n2 // 4, pulse_chunk) // pulse_chunk) * pulse_chunk


def default_compact_capacity(cfg, num_lasers: int) -> int:
    """Default compact capacity, shared with the capacity healers so a
    doubled value stays a pulse_chunk multiple. The slot count is one
    window per block of channel_capacity plus one spill window, per
    channel."""
    slots = num_lasers * (cfg.channel_capacity + cfg.block_points)
    return _cap_from_slots(slots, cfg.pulse_chunk)


def check_supported(cfg: SnowfallConfig) -> None:
    if cfg.assembly != "dense":
        raise NotImplementedError(
            f"assembly={cfg.assembly!r}: the window assembly is not ported "
            "yet (ROADMAP.md, Open items 1, window assembly); use "
            "assembly='dense', whose output equals it"
        )
    if cfg.route_band > 0 or cfg.band_width > 0:
        raise NotImplementedError(
            "route_band/band_width select kernels A2/A3, which are not "
            "ported yet (ROADMAP.md, Open items 2)"
        )


def _plane_and_noise(xyz, intensity, mask, dist, draws, cfg, plane):
    """Ground plane -> incident angles -> adaptive noise polynomial at
    every point's range (simulation.py:449-469)."""
    if plane is None:
        w, h = ransac_plane(xyz, mask, draws)
    else:
        w, h = plane
    hog = xyz @ w + h
    ground = mask & (hog < cfg.ground_delta) & (hog > -cfg.ground_delta)
    incident = torch.arccos(torch.clamp(
        (xyz @ w) / (dist.clamp_min(1e-12) * torch.linalg.vector_norm(w)),
        -1, 1,
    ))
    _, threshold = estimate_laser_parameters(
        xyz, intensity, incident, ground, noise_floor=cfg.noise_floor
    )
    threshold = threshold * torch.cos(incident)
    noise_poly = masked_polyfit2(dist, threshold, ground)
    return polyval2(noise_poly, dist)


@dataclasses.dataclass
class DenseLayout:
    """A scan laid out for phase A: the (channel, azimuth)-sorted payload,
    the chunk windows, and the arguments of `find_occluders`."""

    n: int
    n_pad: int
    n_chunks: int
    blk: int
    bpc1: int               # windows per channel
    xyz: torch.Tensor       # (n, 3) original order
    intensity: torch.Tensor
    mask: torch.Tensor
    noise_at: torch.Tensor  # (n,)
    sorted_cols: torch.Tensor  # (4, n_pad) sorted x, y, z, intensity
    sperm: torch.Tensor     # (n_pad,) sorted -> original index (n = pad)
    valid_blk: torch.Tensor  # (n_chunks, blk) in-channel rows
    rank_flat: torch.Tensor  # (n_chunks * blk,) sorted rank of each slot
    channel_overflow: torch.Tensor
    window_overflow: torch.Tensor
    occluder_args: tuple     # positional arguments of find_occluders
    occluder_kw: dict        # its keyword arguments


def dense_layout(points, mask, bank: BankTensors, order, draws,
                 cfg: SnowfallConfig, plane=None) -> DenseLayout:
    """Plane fit, noise floor and the phase-A layout of one padded scan
    (models/snowfall.py:468-885, Pallas branch)."""
    check_supported(cfg)
    dev = points.device
    n = points.shape[0]
    n_ch = order.shape[0]
    pch, blk = cfg.channel_capacity, cfg.block_points
    if pch % blk:
        raise ValueError("channel_capacity must be divisible by block_points")
    k_ext = bank.data_t.shape[2]
    w_sl = min(cfg.slice_width, k_ext)
    w_pallas = w_sl + 128   # slice start aligned down to 128, 128 wider

    xyz = points[:, :3]
    intensity = points[:, 3]
    channel = points[:, 4].to(torch.int64).clamp(0, n_ch - 1)
    dist = norm3(xyz)
    noise_at = _plane_and_noise(xyz, intensity, mask, dist, draws, cfg, plane)

    az = torch.atan2(xyz[:, 1], xyz[:, 0])
    sort_key = torch.where(mask, channel.to(torch.float32) * 8.0 + az, 1e9)
    delta = cfg.beam_divergence_rad / 2 + cfg.wide_threshold

    s_key, perm = torch.sort(sort_key, stable=True)
    cols = torch.stack([xyz[:, 0], xyz[:, 1], xyz[:, 2], intensity])[:, perm]
    n_pad = -(-n // blk) * blk
    if n_pad != n:
        s_key = torch.nn.functional.pad(s_key, (0, n_pad - n), value=1e9)
        cols = torch.nn.functional.pad(cols, (0, n_pad - n))
        perm = torch.nn.functional.pad(perm, (0, n_pad - n), value=n)
    sx, sy, sz = cols[0], cols[1], cols[2]
    bounds = torch.searchsorted(
        s_key, 8.0 * torch.arange(n_ch + 1, dtype=torch.float32, device=dev)
        - 4.0
    )
    start = bounds[:-1]
    count_full = bounds[1:] - bounds[:-1]
    channel_overflow = (count_full - pch).clamp_min(0).sum()
    end = start + count_full.clamp_max(pch)

    # one extra window per channel: aligning a channel's first window down
    # to a block boundary can push its last points past the last regular
    # window; windows starting past n_pad - blk are clipped dead
    bpc1 = pch // blk + 1
    n_chunks = n_ch * bpc1
    ch_of_chunk = torch.arange(n_ch, device=dev).repeat_interleave(bpc1)
    b_of_chunk = torch.arange(bpc1, device=dev).repeat(n_ch)
    start_c = start[ch_of_chunk]
    end_c = end[ch_of_chunk]
    w0_raw = (start_c // blk) * blk + b_of_chunk * blk
    alive = w0_raw <= n_pad - blk
    w0 = w0_raw.clamp(0, n_pad - blk)
    row_of_chunk = order[ch_of_chunk]
    rank_blk = w0[:, None] + torch.arange(blk, device=dev)[None, :]
    valid_blk = (
        alive[:, None]
        & (rank_blk >= start_c[:, None])
        & (rank_blk < end_c[:, None])
    )
    a_lo = torch.maximum(w0, start_c)
    a_hi = torch.minimum(w0 + blk, end_c)
    has = alive & (a_lo < a_hi)

    # azimuth ascends within a channel, so a window's bounds are its first
    # and last in-channel rows, recomputed with the sort key's atan2
    ia = a_lo.clamp(0, n_pad - 1)
    ib = (a_hi - 1).clamp(0, n_pad - 1)
    min_az = torch.where(has, torch.atan2(sy[ia], sx[ia]), float("inf"))
    max_az = torch.where(has, torch.atan2(sy[ib], sx[ib]), -float("inf"))
    # conservative slice bounds from the bank's azimuth-bin LUT (+-1 bin)
    inv_w = LUT_BINS / (LUT_HI - LUT_LO)
    b_lo = torch.clamp(
        torch.floor((min_az - delta - LUT_LO) * inv_w) - 1, 0, LUT_BINS
    ).to(torch.int64)
    b_hi = torch.clamp(
        torch.floor((max_az + delta - LUT_LO) * inv_w) + 2, 0, LUT_BINS
    ).to(torch.int64)
    lo_raw = bank.lut[row_of_chunk, b_lo]
    hi_req = bank.lut[row_of_chunk, b_hi]
    lo = lo_raw.clamp(0, max(k_ext - w_pallas, 0))
    lo = (lo // 128) * 128
    # a slice at least count wide covers one wrap period = every particle,
    # so only count > w_pallas can under-cover
    counts = bank.count
    uncovered = counts[row_of_chunk] > w_pallas
    window_overflow = torch.where(
        has & uncovered, (hi_req - (lo + w_pallas)).clamp_min(0), 0
    ).sum()

    feats = point_features(sx, sy, sz, cfg.beam_divergence_rad)
    i32 = torch.int32
    return DenseLayout(
        n=n, n_pad=n_pad, n_chunks=n_chunks, blk=blk, bpc1=bpc1,
        xyz=xyz, intensity=intensity, mask=mask, noise_at=noise_at,
        sorted_cols=cols, sperm=perm, valid_blk=valid_blk,
        rank_flat=rank_blk.reshape(-1),
        channel_overflow=channel_overflow, window_overflow=window_overflow,
        occluder_args=(
            feats.contiguous(), (w0 // blk).to(i32),
            row_of_chunk.to(i32), lo.to(i32), has.to(i32),
            counts.to(i32), bank.data_t, bank.wide_t,
        ),
        occluder_kw=dict(blk=blk, w_sl=w_pallas, k_occ=cfg.max_occluders),
    )


@dataclasses.dataclass
class Compacted:
    """The occluded beams after phase B, and the arguments of
    `pulse_peaks`."""

    cap: int
    count_bucketed: bool
    cidx: torch.Tensor      # (cap,) slot of each compacted beam (n2 = dead)
    c_ok: torch.Tensor      # (cap,) live entry
    c_xyz: torch.Tensor     # (cap, 3)
    c_int: torch.Tensor
    c_orig: torch.Tensor    # original point index
    c_d: torch.Tensor
    c_lut: tuple            # per-beam min_int, focal_slope, focal_offset, max_int
    occluder_overflow: torch.Tensor
    compact_overflow: torch.Tensor
    pulse_args: tuple
    pulse_kw: dict


def compact_occluded(lay: DenseLayout, a12d, ovf, calib: CalibTensors,
                     cfg: SnowfallConfig) -> Compacted:
    """Phase B (models/snowfall.py:985-1085): keep the beams with at least
    one occluder, ordered by (occluder count, slot), and build phase C's
    K-outer inputs."""
    dev = a12d.device
    k_occ = cfg.max_occluders
    blk, n_chunks = lay.blk, lay.n_chunks
    n2 = n_chunks * blk
    occ_valid = (
        a12d[2 * k_occ:].reshape(k_occ, n_chunks, blk) < 1e37
    ) & lay.valid_blk[None]
    occ_of = torch.where(lay.valid_blk, ovf, 0).sum()
    any_occ = occ_valid.any(dim=0).reshape(n2)

    cap = cfg.compact_capacity or _cap_from_slots(n2, cfg.pulse_chunk)
    if cap % cfg.pulse_chunk:
        raise ValueError("compact_capacity must be divisible by pulse_chunk")
    compact_overflow = (any_occ.sum() - cap).clamp_min(0)
    # count-bucketed order: on the TPU this keeps pulse blocks' trip counts
    # homogeneous; here it fixes the compacted order the JAX package uses
    slot = torch.arange(n2, device=dev)
    count_bucketed = (k_occ + 1) * n2 < 2**31
    if count_bucketed:
        n_occ_slot = occ_valid.sum(dim=0).reshape(n2)
        big_key = _I32_MAX
        ckey = torch.where(any_occ, n_occ_slot * n2 + slot, big_key)
    else:
        big_key = n2
        ckey = torch.where(any_occ, slot, n2)
    skey, by_key = torch.sort(ckey, stable=True)
    rank_sorted = lay.rank_flat[by_key]
    if cap > n2:
        skey = torch.nn.functional.pad(skey, (0, cap - n2), value=big_key)
        rank_sorted = torch.nn.functional.pad(rank_sorted, (0, cap - n2))
    skey, rank_ci = skey[:cap], rank_sorted[:cap]
    cidx = torch.where(skey == big_key, n2, skey % n2) if count_bucketed \
        else skey
    c_ok = cidx < n2
    ci = cidx.clamp(0, n2 - 1)

    c_ch = (ci // blk) // lay.bpc1
    rk = rank_ci.clamp(0, lay.n_pad - 1)
    gs = lay.sorted_cols[:, rk]                          # (4, cap)
    c_xyz = gs[:3].T
    c_int = gs[3]
    c_orig = lay.sperm[rk]
    gm = a12d[:, ci]                                     # (3K, cap)
    c_a1, c_a2, c_rr = gm[:k_occ], gm[k_occ:2 * k_occ], gm[2 * k_occ:]
    c_valid = ((c_rr < 1e37) & c_ok[None, :]).to(torch.float32)

    c_d = norm3(c_xyz)
    c_right, c_left = beam_limits(gs[0], gs[1], cfg.beam_divergence_rad)
    c_lut = (calib.min_intensity[c_ch], calib.focal_slope[c_ch],
             calib.focal_offset[c_ch], calib.max_intensity[c_ch])
    feats = torch.stack([c_d, c_right, c_left, 0.9 * c_lut[3]])
    c_tau = SPEED_OF_LIGHT * cfg.tau_h
    phase = 2.0 * math.pi / c_tau
    all_r = torch.cat([c_rr, c_d[None]], dim=0)          # (K+1, cap)
    range_grid = torch.as_tensor(cfg.range_grid(), device=dev)
    gph = phase * range_grid
    return Compacted(
        cap=cap, count_bucketed=count_bucketed, cidx=cidx, c_ok=c_ok,
        c_xyz=c_xyz, c_int=c_int, c_orig=c_orig, c_d=c_d, c_lut=c_lut,
        occluder_overflow=occ_of, compact_overflow=compact_overflow,
        pulse_args=(
            feats, c_a1, c_a2, c_rr.contiguous(), c_valid,
            torch.cos(phase * all_r), torch.sin(phase * all_r),
            torch.cos(gph), torch.sin(gph),
        ),
        pulse_kw=dict(
            beam_rad=cfg.beam_divergence_rad,
            ipm=float(cfg.intervals_per_meter), c_tau=c_tau,
            xsi_r1=cfg.xsi_r1, xsi_r2=cfg.xsi_r2,
        ),
    )


def scatter_back(lay: DenseLayout, comp: Compacted, pulse_out,
                 cfg: SnowfallConfig) -> SnowfallResult:
    """Decision tail (simulation.py:151-192) and phase D, the touched-only
    scatter back to the original order (models/snowfall.py:1155-1325)."""
    i_peak, peak_idx, touched, _ = pulse_out
    cap, c_ok = comp.cap, comp.c_ok
    c_min, c_fs, c_fo, c_max = comp.c_lut
    c_d = comp.c_d
    ipm = float(cfg.intervals_per_meter)
    c_tau = SPEED_OF_LIGHT * cfg.tau_h

    d_max = div(peak_idx.to(torch.float32), ipm) - c_tau / 2
    i_max = i_peak + c_max * c_fs * torch.abs(
        c_fo - (1 - div(d_max, cfg.lidar_range)) ** 2
    )
    i_max = torch.clamp(i_max, c_min, c_max)
    attenuated = torch.abs(d_max - c_d) < cfg.range_tolerance
    new_i = torch.floor(i_max)
    lab = torch.where(touched, torch.where(attenuated, 1.0, 2.0), 0.0)
    scale_r = torch.where(
        touched & ~attenuated, d_max / c_d.clamp_min(1e-12), 1.0
    )
    nx = comp.c_xyz * scale_r[:, None]
    ni = torch.where(touched, torch.clamp(new_i, c_min, c_max), comp.c_int)
    contrib = torch.where(
        touched & attenuated & c_ok, 0.9 * c_max - new_i, 0.0
    )
    if comp.count_bucketed:
        # back to slot order, so the f32 sum sees the slot-ordered array
        contrib = contrib[torch.sort(comp.cidx, stable=True).indices]
    diff_sum = contrib.sum()

    n = lay.n
    tgt = torch.where(c_ok, comp.c_orig, n)     # n: dropped extra slot
    lab_i = lab.to(torch.int32)
    packed_new = torch.round(ni).to(torch.int32) * 4 + lab_i
    tcap = min(cfg.touch_capacity or max(3 * cap // 4, 256), cap)
    scap = min(cfg.scatter_capacity or max(cap // 4, 256), tcap)
    planes = torch.nn.functional.pad(lay.xyz.T, (0, 1))   # (3, n + 1)
    touch_overflow = torch.zeros((), dtype=torch.int64, device=c_ok.device)
    if tcap < cap:
        # an untouched beam scatters back identical values (scale 1.0, its
        # own intensity, label 0), so only label > 0 beams update intensity
        # and label, and only label 2 beams move
        is_scat = c_ok & (lab_i == 2)
        is_touch = c_ok & (lab_i > 0)
        seg = torch.where(
            is_scat, 0,
            torch.where(is_touch, cap, torch.where(c_ok, 2 * cap, 3 * cap)),
        )
        t_idx = torch.sort(seg, stable=True).indices[:tcap]
        touch_overflow = (
            (is_scat.sum() - scap).clamp_min(0)
            + (is_touch.sum() - tcap).clamp_min(0)
        )
        t_tgt = tgt[t_idx]
        planes[:, t_tgt[:scap]] = nx[t_idx[:scap]].T
        scatter_tgt, scatter_val = t_tgt, packed_new[t_idx]
    else:
        planes[:, tgt] = nx.T
        scatter_tgt, scatter_val = tgt, packed_new
    # intensity and label ride one int32: round(i) * 4 + label is lossless
    packed = torch.nn.functional.pad(
        torch.round(lay.intensity).to(torch.int32) * 4, (0, 1)
    )
    packed[scatter_tgt] = scatter_val
    packed = packed[:n]
    new_int = (packed >> 2).to(torch.float32)
    label = (packed & 3).to(torch.float32)

    mask = lay.mask
    keep = mask & ((label == 2) | (new_int > lay.noise_at))
    num_removed = (mask & ~keep).sum()
    num_attenuated = (keep & (label == 1)).sum()
    avg_diff = torch.where(
        num_attenuated > 0,
        (diff_sum / num_attenuated.clamp_min(1)).to(torch.int32),
        0,
    )
    i32 = torch.int32
    return SnowfallResult(
        planes=torch.cat([planes[:, :n], new_int[None], label[None]]),
        keep=keep,
        num_attenuated=num_attenuated.to(i32),
        num_removed=num_removed.to(i32),
        avg_intensity_diff=avg_diff.to(i32),
        window_overflow=lay.window_overflow.to(i32),
        occluder_overflow=comp.occluder_overflow.to(i32),
        bump_overflow=torch.zeros((), dtype=i32, device=mask.device),
        channel_overflow=lay.channel_overflow.to(i32),
        compact_overflow=(comp.compact_overflow + touch_overflow).to(i32),
    )


def snowfall_augment_dense(points, mask, bank: BankTensors,
                           calib: CalibTensors, order, draws,
                           cfg: SnowfallConfig, plane=None) -> SnowfallResult:
    """Dense-slice snowfall augmentation of one padded scan.

    Args:
      points: (N, 5) f32 padded scan (x, y, z, intensity, channel)
      mask:   (N,) bool validity
      bank, calib: `bank_to_torch` / `calib_to_torch` tensors
      order:  (num_channels,) int64 channel -> bank-row permutation
      draws:  (ransac_trials, 3) f32 RANSAC uniforms (unused with `plane`)
      plane:  optional (w (3,), h) ground plane, skipping RANSAC

    Returns a SnowfallResult in the original point order; compact on the
    host with `keep`.
    """
    lay = dense_layout(points, mask, bank, order, draws, cfg, plane)
    a12d, ovf = find_occluders(*lay.occluder_args, **lay.occluder_kw)
    comp = compact_occluded(lay, a12d, ovf, calib, cfg)
    out = pulse_peaks(*comp.pulse_args, **comp.pulse_kw)
    return scatter_back(lay, comp, out, cfg)


def grown_config(cfg: SnowfallConfig, name: str, k_ext: int,
                 num_lasers: int):
    """The config with the capacity behind overflow counter `name`
    doubled, or None when nothing can grow (the dense assembly's healers,
    models/snowfall.py:1358-1402)."""
    if name == "window_overflow":
        if cfg.slice_width >= k_ext:
            return None
        new = dict(slice_width=min(cfg.slice_width * 2, k_ext))
    elif name == "occluder_overflow":
        new = dict(
            max_occluders=cfg.max_occluders * 2,
            max_bumps=max(cfg.max_bumps, cfg.max_occluders * 2),
        )
    elif name == "bump_overflow":
        if min(cfg.max_bumps * 2, cfg.max_occluders) == cfg.max_bumps:
            return None
        new = dict(max_bumps=min(cfg.max_bumps * 2, cfg.max_occluders))
    elif name == "channel_overflow":
        new = dict(channel_capacity=cfg.channel_capacity * 2)
    elif name == "compact_overflow":
        cap = cfg.compact_capacity or default_compact_capacity(
            cfg, num_lasers
        )
        new = dict(compact_capacity=cap * 2)
        # explicit touch/scatter caps scale along; auto ones follow cap
        if cfg.touch_capacity:
            new["touch_capacity"] = min(cfg.touch_capacity * 2, cap * 2)
        if cfg.scatter_capacity:
            new["scatter_capacity"] = min(cfg.scatter_capacity * 2, cap * 2)
    else:
        return None
    return dataclasses.replace(cfg, **new)


@dataclasses.dataclass
class SnowfallAugmenter:
    """Host wrapper: pads, runs the dense assembly on `device`, grows any
    overflowed capacity and reruns, compacts. Mirrors the reference's
    `augment(pc, ...) -> (stats, aug_pc)` contract.

    The default config is the dense assembly, whose output equals the
    window assembly's (the JAX package's default) on every scan.
    """

    bank: ParticleBank
    calib: SensorCalib
    cfg: SnowfallConfig = SnowfallConfig(assembly="dense")
    seed: int = 0
    device: str | torch.device = "cpu"

    def __post_init__(self):
        check_supported(self.cfg)
        self.device = torch.device(self.device)
        self._bank = bank_to_torch(self.bank, self.device)
        self._calib = calib_to_torch(self.calib, self.device)
        self.last_result: SnowfallResult | None = None

    def __call__(self, pc, order=None, shuffle: bool = True):
        dev = self.device
        if order is None:
            order = np.arange(self.calib.num_lasers)
            if shuffle:
                order = np.random.permutation(order)
        k_ext = int(self.bank.data_t.shape[2])
        padded = pad_cloud(np.asarray(pc), self.cfg.max_points)
        args = (
            torch.as_tensor(padded.points, device=dev),
            torch.as_tensor(padded.mask, device=dev),
            self._bank, self._calib,
            torch.as_tensor(np.asarray(order), dtype=torch.int64, device=dev),
            ransac_draws(self.seed, self.cfg.ransac_trials).to(dev),
        )
        for _attempt in range(8):
            res = snowfall_augment_dense(*args, self.cfg)
            counts = {n: int(getattr(res, n)) for n in OVERFLOW_COUNTERS}
            overflowed = [n for n, c in counts.items() if c]
            if not overflowed:
                break
            grown = self.cfg
            for name in overflowed:
                grown = grown and grown_config(
                    grown, name, k_ext, self.calib.num_lasers
                )
            logger.warning("snowfall capacities grew after %s", counts)
            if grown is None:
                raise RuntimeError(
                    f"capacity overflow not auto-resolvable: {counts}"
                )
            self.cfg = grown
        else:
            raise RuntimeError(
                f"capacity overflows persisted after growth: {counts}"
            )
        self.last_result = res
        stats = (
            int(res.num_attenuated),
            int(res.num_removed),
            int(res.avg_intensity_diff),
        )
        planes = res.planes.cpu().numpy()
        keep = res.keep.cpu().numpy()
        return stats, np.ascontiguousarray(planes.T[keep])
