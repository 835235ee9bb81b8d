"""Snowfall augmentation (counterpart of
`lidar_snow_sim_tpu/models/snowfall.py`): the window assembly
(`snowfall_augment`, kernels W1 and W2) and the dense assembly
(`snowfall_augment_dense`, the JAX package's Pallas branch, on kernels A1-A4b
and C1-C2).

`snowfall_augment` runs the assembly `cfg.assembly` names. The window
assembly (models/snowfall.py:93-419; `window_augment`) stable-sorts the
points by channel, finds each point's angular window in its bank row, then
the nearest K occluders among the window's `window_size` bank columns and
the row's wide list (kernel W1, `ops/occluders.find_occluders_window`), the
first-claim sweep, the `max_bumps` largest bumps and the waveform peak
(kernel W2, `ops/pulse.window_pulse_peaks`), and the decision tail in torch.
On CPU tensors the kernels' plain versions run chunk by chunk of
`point_chunk` points. Its rows come back in that channel-sorted order. Its
window_overflow counts the in-window particles beyond `window_size`, which
no capacity growth resolves (the JAX package's rule).

The dense assembly, per scan:

1. ground plane (RANSAC, draws injected) -> incident angles -> adaptive
   noise polynomial over range (simulation.py:449-469);
2. layout: points stable-sorted by (channel, signed azimuth); chunks are
   `block_points`-wide windows of that order, starts aligned down to a
   block, one spill window per channel, and a `has` gate for windows with
   no in-channel point. Each chunk reads one bank slice of slice_width +
   128 columns, its start aligned down to 128, from the bank's azimuth LUT;
3. phase A (`ops/occluders.py`), the nearest K occluders of every beam, by
   one of five kernels:
   - A1, the full slice per chunk (the default);
   - A2 with `route_band > 0`: chunks whose every `band_group` of beams
     provably fits one `route_band`-wide window (conservative LUT bounds
     per group) test only that band, the rest take A1's body;
   - A3 with `band_width > 0` (supersedes `route_band`): two bands per
     group, head- and tail-anchored, and a per-beam coverage plane that
     counts into window_overflow where the group's hull is uncovered.
   - A4b with `pallas_pair` and an even chunk count: A1's function, two
     chunks per CTA;
   - A4a with `pallas_transposed` (and not `pallas_pair`): A1's function,
     each beam's candidates across 8 lanes.
   A2 and A3 run where the JAX package takes them
   (models/snowfall.py:504-514): `block_points % band_group == 0` and a
   widened slice at least `route_band` (A2) or `2 * band_width` (A3) wide.
   The precedence is the JAX package's (models/snowfall.py:702-716): A3 >
   A2 > A4b > A4a > A1. Only A1 skips chunks with no in-channel beam (its
   `has` gate); A3, A4a and A4b compute them, and every consumer masks
   them out;
4. phase B: the occluded beams compacted, keyed (occluder count, slot);
5. phase C: kernel C1 (`ops/pulse.py`), sweep and pulse peak, or kernel C2
   with `pulse_pair` where the pulse blocks come in pairs (the JAX rule,
   models/snowfall.py:1107-1145), then the label/intensity decision tail in
   torch;
6. phase D: the touched beams scattered back to the original order.

The slice geometry, and so every overflow counter, is the JAX Pallas
branch's, so the counters of the two packages can be compared. Where a
bank row is shorter than the widened slice (the JAX package then takes its
XLA branch, which neither routes nor bands) the port keeps A1's layout
(A4b or A4a under their knobs) and clips the slice to the row: the whole
row up to one wrap period. The XLA branch's slice holds that period too
whenever its width is at least the row's particle count, which holds for
every bank built with window_size >= 64 (a row is count + 2 *
window_size wide). There the output meets the parity contract and every
counter equals the XLA branch's, starved capacities included
(tests/test_torch_snowfall.py::test_clipped_slice_matches_jax). With a
narrower window_size the XLA slice may miss particles and count them in
window_overflow, where the port's clipped slice misses none.

`snowfall_augment_dense` runs one scan; `dense_layout`, `run_phase_a` and
`finish_scan` are its seams, so a batched step (parallel/batched.py) can
fold its frames' A1 chunks into one launch (`run_phase_a_folded`, the
`batch_fold` knob). Every knob gives output identical to the default.

Ignored knobs: use_pallas, pallas_interpret and chunk_group. The device
decides instead: a CUDA tensor goes to the kernels, a CPU tensor to their
plain versions. The JAX package computes the window assembly in plain XLA,
fused inside its lax.map over chunks; W1 and W2 take that place here.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import NamedTuple

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.calib import SensorCalib
from lidar_snow_sim_tpu_torch.config import SPEED_OF_LIGHT, SnowfallConfig
from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.sampling.banks import (
    LUT_BINS,
    LUT_HI,
    LUT_LO,
    ParticleBank,
)
from lidar_snow_sim_tpu_torch.utils.pointcloud import pad_cloud
from lidar_snow_sim_tpu_torch.utils.profiling import span
from lidar_snow_sim_tpu_torch.ops.f32 import div
from lidar_snow_sim_tpu_torch.ops.fitting import ransac_draws, ransac_plane
from lidar_snow_sim_tpu_torch.ops.geometry import beam_limits, norm3
from lidar_snow_sim_tpu_torch.ops.laser import noise_floor_at
from lidar_snow_sim_tpu_torch.ops.occluders import (
    find_occluders,
    find_occluders_banded,
    find_occluders_folded,
    find_occluders_pair,
    find_occluders_routed,
    find_occluders_t,
    find_occluders_window,
    occluders_window_plain,
    point_features,
    window_angles,
)
from lidar_snow_sim_tpu_torch.ops.pulse import (
    pulse_peaks,
    pulse_peaks_pair,
    window_pulse_peaks,
    window_pulse_plain,
)

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
    window_overflow: torch.Tensor  # bank columns a slice (dense) or
    # in-window particles a window_size window (window) failed to cover
    occluder_overflow: torch.Tensor  # hits beyond max_occluders
    bump_overflow: torch.Tensor    # nonzero ratios beyond max_bumps
    # (always 0 on the dense assembly, whose bumps are its occluders)
    channel_overflow: torch.Tensor  # points beyond channel_capacity
    compact_overflow: torch.Tensor  # occluded beyond compact_capacity,
    # plus touched/moved beyond touch_capacity/scatter_capacity


class BankTensors(NamedTuple):
    """The ParticleBank arrays the assemblies read, on one device."""

    data_t: torch.Tensor   # (C, 8, K_ext) f32 property rows
    wide_t: torch.Tensor   # (C, 8, Wc) f32
    count: torch.Tensor    # (C,) int32 narrow count
    lut: torch.Tensor      # (C, LUT_BINS + 1) int64 azimuth -> column
    # the window assembly's views of data_t and wide_t (the bank's data,
    # angle and wide arrays, equal to them bit for bit)
    data: torch.Tensor     # (C, K_ext, 4) x, y, r, dist
    angle: torch.Tensor    # (C, K_ext) signed extended sort azimuth
    wide: torch.Tensor     # (C, W, 4), W = the bank's wide capacity
    # the window assembly's per-column angle tables [pang, start, end]
    # (ops/occluders.window_angles), made once a bank on its device
    ang_t: torch.Tensor    # (C, 3, K_ext) f32
    wang_t: torch.Tensor   # (C, 3, W) f32

    def to(self, device) -> "BankTensors":
        """The bank on `device`: data_t, wide_t, count and lut copied once
        (not copied where they already lie there), the views and the angle
        tables re-made there."""
        data_t, wide_t = self.data_t.to(device), self.wide_t.to(device)
        if data_t is self.data_t and wide_t is self.wide_t:
            return self
        return _bank_tensors(data_t, wide_t, self.count.to(device),
                             self.lut.to(device), self.wide.shape[1])


def _bank_tensors(data_t, wide_t, count, lut, n_wide: int) -> BankTensors:
    ang_t, wang_t = window_angles(data_t, wide_t, n_wide)
    return BankTensors(
        data_t=data_t, wide_t=wide_t, count=count, lut=lut,
        data=data_t[:, :4].transpose(1, 2), angle=data_t[:, 6],
        wide=wide_t[:, :4, :n_wide].transpose(1, 2), ang_t=ang_t,
        wang_t=wang_t,
    )


class CalibTensors(NamedTuple):
    min_intensity: torch.Tensor
    focal_distance: torch.Tensor
    focal_slope: torch.Tensor
    focal_offset: torch.Tensor
    max_intensity: torch.Tensor

    def to(self, device) -> "CalibTensors":
        return CalibTensors(*(t.to(device) for t in self))


def bank_to_torch(bank: ParticleBank, device) -> BankTensors:
    data_t = torch.as_tensor(bank.data_t, dtype=torch.float32,
                             device=device).contiguous()
    wide_t = torch.as_tensor(bank.wide_t, dtype=torch.float32,
                             device=device).contiguous()
    return _bank_tensors(
        data_t, wide_t,
        torch.as_tensor(bank.count, dtype=torch.int32, device=device),
        torch.as_tensor(bank.lut, dtype=torch.int64, device=device),
        bank.wide.shape[1])


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


def _plane_and_noise(xyz, intensity, mask, dist, draws, cfg, plane):
    """Ground plane -> incident angles -> adaptive noise polynomial at
    every point's range (simulation.py:449-469): on CUDA tensors kernels P1
    (skipped when `plane` is given) and P2, two launches and no host sync."""
    with span("snowfall.plane_noise"):
        if plane is None:
            plane = ransac_plane(xyz, mask, draws)
        return noise_floor_at(xyz, intensity, mask, dist, plane, cfg)


def _batched_searchsorted(sorted_rows, rows, targets, length: int):
    """First index i of sorted_rows[rows] with value >= target (side
    'left'), by log2(length) + 1 bisection steps of one gather each, as the
    JAX package computes it (a target above the row's last value can end at
    length + 1)."""
    lo = torch.zeros(targets.shape[0], dtype=torch.int64,
                     device=targets.device)
    hi = torch.full_like(lo, length)
    for _ in range(int(np.ceil(np.log2(max(length, 2)))) + 1):
        mid = (lo + hi) // 2
        go_right = sorted_rows[rows, mid.clamp(0, length - 1)] < targets
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(go_right, hi, mid))
    return lo


def _pulse_tail(xyz, intensity, point_valid, i_peak, peak_idx, touched_any,
                min_int, max_int, focal_slope, focal_offset,
                cfg: SnowfallConfig):
    """The window assembly's decision tail of P points after their pulse
    peak (`ops/pulse.window_pulse_plain`; simulation.py:151-192): returns
    (new_xyz, new_intensity, label, diff), diff (P,) each point's share of
    the stats' intensity-difference sum."""
    ipm = cfg.intervals_per_meter
    c_tau = SPEED_OF_LIGHT * cfg.tau_h
    d_orig = norm3(xyz)
    d_max = div(peak_idx.to(torch.float32), ipm) - c_tau / 2

    # focal-slope re-adjustment and clipping (simulation.py:155-156)
    i_max = i_peak + max_int * focal_slope * torch.abs(
        focal_offset - (1 - div(d_max, cfg.lidar_range)) ** 2
    )
    i_max = torch.clamp(i_max, min_int, max_int)
    attenuated = torch.abs(d_max - d_orig) < cfg.range_tolerance
    new_i = torch.floor(i_max)   # int() truncation: i_max >= min_int >= 0

    label = torch.where(touched_any, torch.where(attenuated, 1.0, 2.0), 0.0)
    scale = torch.where(touched_any & ~attenuated, d_max / d_orig, 1.0)
    new_intensity = torch.where(
        touched_any, torch.clamp(new_i, min_int, max_int), intensity)
    diff = torch.where(touched_any & attenuated & point_valid,
                       0.9 * max_int - new_i, 0.0)
    return xyz * scale[:, None], new_intensity, label, diff


def snowfall_augment(points, mask, bank: BankTensors, calib: CalibTensors,
                     order, draws, cfg: SnowfallConfig,
                     plane=None) -> SnowfallResult:
    """Snowfall augmentation of one padded scan on the assembly that
    `cfg.assembly` names.

    Args as `snowfall_augment_dense`. "window" (`window_augment`; kernels
    W1 and W2 on CUDA tensors, the chunked plain path on CPU tensors)
    returns its rows in channel-sorted order (a stable sort on the
    channel, padding last); "dense" (`snowfall_augment_dense`) in the
    original order. On a scan already stable-sorted by channel the two give
    the same output.
    """
    if cfg.assembly == "dense":
        return snowfall_augment_dense(points, mask, bank, calib, order,
                                      draws, cfg, plane=plane)
    if cfg.assembly != "window":
        raise ValueError(f"unknown assembly {cfg.assembly!r}")
    return window_augment(points, mask, bank, calib, order, draws, cfg,
                          plane=plane)


class WindowInputs(NamedTuple):
    """A scan stable-sorted by channel (padding last) with what the window
    assembly's kernels take for each point."""

    xyz: torch.Tensor          # (N, 3)
    intensity: torch.Tensor
    mask: torch.Tensor
    noise_at: torch.Tensor
    bank_row: torch.Tensor     # (N,) int64
    lo: torch.Tensor           # (N,) first window column
    n_window: torch.Tensor     # (N,) particles in the angular window
    feats: torch.Tensor        # (N, 9) point_features (8: signed azimuth)
    min_int: torch.Tensor      # (N,) the channel's calibration
    max_int: torch.Tensor
    focal_slope: torch.Tensor
    focal_offset: torch.Tensor
    range_grid: torch.Tensor   # (M,)


def window_inputs(points, mask, bank: BankTensors, calib: CalibTensors,
                  order, draws, cfg: SnowfallConfig,
                  plane=None) -> WindowInputs:
    """Steps 1-3 of the window assembly (models/snowfall.py:307-350): the
    stable sort by channel, the plane and noise floor, the per-point
    channel tables and angular windows in the bank's signed sort azimuth.
    The points' feature rows (`ops/occluders.point_features`) are made once
    here: their signed azimuth is the window's centre, and kernels W1 and
    W2 both read them."""
    with span("snowfall.window_inputs"):
        n_ch = order.shape[0]
        perm = torch.sort(torch.where(mask, points[:, 4], 1e9), stable=True
                          ).indices
        points, mask = points[perm], mask[perm]
        xyz, intensity = points[:, :3], points[:, 3]
        channel = points[:, 4].to(torch.int64).clamp(0, n_ch - 1)
        noise_at = _plane_and_noise(xyz, intensity, mask, norm3(xyz), draws,
                                    cfg, plane)
        bank_row = order[channel]
        feats = point_features(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                               cfg.beam_divergence_rad)
        center = feats[:, 8]
        delta = window_delta(cfg)
        k_ext = bank.angle.shape[1]
        lo = _batched_searchsorted(bank.angle, bank_row, center - delta,
                                   k_ext)
        n_window = _batched_searchsorted(bank.angle, bank_row,
                                         center + delta, k_ext) - lo
        return WindowInputs(
            xyz=xyz, intensity=intensity, mask=mask, noise_at=noise_at,
            bank_row=bank_row, lo=lo, n_window=n_window, feats=feats,
            min_int=calib.min_intensity[channel],
            max_int=calib.max_intensity[channel],
            focal_slope=calib.focal_slope[channel],
            focal_offset=calib.focal_offset[channel],
            range_grid=torch.as_tensor(cfg.range_grid(), device=points.device),
        )


def window_delta(cfg: SnowfallConfig) -> float:
    """Half-width of a point's angular window: half the beam plus the wide
    threshold."""
    return cfg.beam_divergence_rad / 2 + cfg.wide_threshold


def window_occluder_call(inp: WindowInputs, bank: BankTensors,
                         cfg: SnowfallConfig, sl=slice(None)):
    """(args, kwargs) of `find_occluders_window` (kernel W1) and its plain
    version for the points `sl` of `inp`, on their feature rows, with the
    scan's mask as the live mask (the padding rows get the empty outputs;
    `dict(kw, live=None)` computes every row)."""
    return ((inp.feats[sl], inp.bank_row[sl], inp.lo[sl], bank.data_t,
             bank.wide_t, bank.ang_t, bank.wang_t),
            dict(window_size=cfg.window_size, delta=window_delta(cfg),
                 k_occ=cfg.max_occluders, live=inp.mask[sl]))


def window_pulse_call(inp: WindowInputs, occ, cfg: SnowfallConfig,
                      sl=slice(None)):
    """(args, kwargs) of `window_pulse_peaks` (kernel W2) and its plain
    version for the points `sl` of `inp` with their occluders `occ` (the
    first four outputs of W1), as `window_occluder_call` makes W1's."""
    return ((inp.feats[sl], inp.max_int[sl], *occ[:4], inp.range_grid),
            dict(beam_rad=cfg.beam_divergence_rad,
                 ipm=cfg.intervals_per_meter, tau_h=cfg.tau_h,
                 max_bumps=cfg.max_bumps, live=inp.mask[sl]))


def window_augment(points, mask, bank: BankTensors, calib: CalibTensors,
                   order, draws, cfg: SnowfallConfig, plane=None, *,
                   plain: bool = False) -> SnowfallResult:
    """The window assembly of one padded scan (models/snowfall.py:268-417).

    On CUDA tensors: kernel W1 (`ops/occluders.find_occluders_window`) and
    kernel W2 (`ops/pulse.window_pulse_peaks`), one launch each over all
    points, on one set of feature rows (`window_inputs`) and with the scan's
    mask as their live mask: the padding rows, which no consumer reads (the
    keep rule and every counter are masked), get the kernels' empty outputs
    without a test. On CPU tensors, or with plain=True on any device: their plain
    versions chunk by chunk of `point_chunk` points, as the JAX package's
    lax.map (a (P, M) waveform plane per bump). Both give the same bytes on
    one device: the kernels equal their plain versions, and the decision
    tail and the stats are the same code (the intensity differences summed
    a chunk at a time, then over the chunks)."""
    n = points.shape[0]
    p_chunk = cfg.point_chunk
    if n % p_chunk:
        raise ValueError(f"max_points {n} is not a multiple of point_chunk "
                         f"{p_chunk}")
    inp = window_inputs(points, mask, bank, calib, order, draws, cfg, plane)
    with span("snowfall.window_kernels"):
        if points.device.type == "cuda" and not plain:
            args, kw = window_occluder_call(inp, bank, cfg)
            occ = find_occluders_window(*args, **kw)
            args, kw = window_pulse_call(inp, occ, cfg)
            peaks = window_pulse_peaks(*args, **kw)
            occ_of = occ[4]
        else:
            chunks = []
            for c0 in range(0, n, p_chunk):
                sl = slice(c0, c0 + p_chunk)
                args, kw = window_occluder_call(inp, bank, cfg, sl)
                occ = occluders_window_plain(*args, **kw)
                args, kw = window_pulse_call(inp, occ, cfg, sl)
                chunks.append((*window_pulse_plain(*args, **kw), occ[4]))
            *peaks, occ_of = (torch.cat(parts) for parts in zip(*chunks))
    with span("snowfall.tail"):
        i_peak, peak_idx, touched, bump_of = peaks
        mask = inp.mask
        new_xyz, new_int, label, diff = _pulse_tail(
            inp.xyz, inp.intensity, mask, i_peak, peak_idx, touched,
            inp.min_int, inp.max_int, inp.focal_slope, inp.focal_offset, cfg)

        # 5. rounded intensities, the noise-floor keep rule, stats
        new_int = torch.round(new_int)
        keep = mask & ((label == 2) | (new_int > inp.noise_at))
        num_removed = (mask & ~keep).sum()
        num_attenuated = (keep & (label == 1)).sum()
        diff_sum = torch.stack([d.sum() for d in diff.split(p_chunk)]).sum()
        avg_diff = torch.where(
            num_attenuated > 0,
            (diff_sum / num_attenuated.clamp_min(1)).to(torch.int32), 0)
        win_of = (inp.n_window - cfg.window_size).clamp_min(0)
        i32 = torch.int32
        zero = torch.zeros((), dtype=i32, device=points.device)
        return SnowfallResult(
            planes=torch.stack([new_xyz[:, 0], new_xyz[:, 1], new_xyz[:, 2],
                                new_int, label]),
            keep=keep,
            num_attenuated=num_attenuated.to(i32),
            num_removed=num_removed.to(i32),
            avg_intensity_diff=avg_diff.to(i32),
            window_overflow=torch.where(mask, win_of, 0).sum().to(i32),
            occluder_overflow=torch.where(mask, occ_of, 0).sum().to(i32),
            bump_overflow=torch.where(mask, bump_of, 0).sum().to(i32),
            channel_overflow=zero,
            compact_overflow=zero,
        )


@dataclasses.dataclass
class DenseLayout:
    """A scan laid out for phase A: the (channel, azimuth)-sorted payload,
    the chunk windows, and the phase-A kernel with its arguments."""

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
    window_overflow: torch.Tensor  # the layout's share (see run_phase_a)
    kernel: str              # phase-A kernel: "A1", "A2", "A3", "A4a", "A4b"
    occluder_args: tuple     # positional arguments of its wrapper
    occluder_kw: dict        # its keyword arguments
    # (n_chunks,) each chunk's bank-slice start; A3's bands lie inside the
    # slice, and its kernel reads them from the bank directly
    slice_lo: torch.Tensor
    # A3: (n_chunks, blk) in-channel beams whose group's LUT hull its band
    # A does not cover; those the kernel finds uncovered count as overflow
    cover_mask: torch.Tensor | None = None


def _lut_bounds(bank: BankTensors, rows, min_az, max_az, delta: float):
    """Conservative bank-column bounds (lo, hi) of the azimuth windows
    [min_az - delta, max_az + delta] in bank rows `rows`, from the bank's
    azimuth-bin LUT with a one-bin guard on each side."""
    inv_w = LUT_BINS / (LUT_HI - LUT_LO)
    b_lo = torch.clamp(
        torch.floor((min_az - delta - LUT_LO) * inv_w) - 1, 0, LUT_BINS
    ).to(torch.int64)
    b_hi = torch.clamp(
        torch.floor((max_az + delta - LUT_LO) * inv_w) + 2, 0, LUT_BINS
    ).to(torch.int64)
    return bank.lut[rows, b_lo], bank.lut[rows, b_hi]


def group_az_bounds(sx, sy, s_key, w0_raw, ch_of_chunk, gsz: int,
                    g_dim: int):
    """Azimuth bounds (min, max), each (n_chunks, G), of the in-channel
    rows of every chunk's `gsz`-row groups (models/snowfall.py:591-665).

    The JAX package's rule, kept exactly: statistics are taken over every
    `gsz`-aligned window of the sorted order under two hypotheses, the
    channel of the window's first row and that of its last; a chunk takes
    the one that is its own channel. A window holding three channels (a
    channel of fewer than `gsz` rows in its middle) matches neither for the
    middle one, whose bounds fall back to -1e9 / 1e9. Callers mask groups
    without an in-channel row.
    """
    inf = float("inf")
    wz = torch.atan2(sy, sx).reshape(-1, gsz)
    wch = torch.round(s_key / 8.0).to(torch.int64).reshape(-1, gsz)
    chf, chl = wch[:, 0], wch[:, -1]
    mf = wch == chf[:, None]
    ml = wch == chl[:, None]
    minf = torch.where(mf, wz, inf).amin(dim=1)
    maxf = torch.where(mf, wz, -inf).amax(dim=1)
    minl = torch.where(ml, wz, inf).amin(dim=1)
    maxl = torch.where(ml, wz, -inf).amax(dim=1)
    n_win = wz.shape[0]
    win = (w0_raw // gsz)[:, None] + torch.arange(g_dim, device=sx.device)
    inside = win < n_win          # windows past the end hold no row
    win = win.clamp(max=n_win - 1)
    ch = ch_of_chunk[:, None]
    sel_f = inside & (chf[win] == ch)
    sel_l = inside & (chl[win] == ch)
    lo = torch.where(sel_f, minf[win], torch.where(sel_l, minl[win], -1e9))
    hi = torch.where(sel_f, maxf[win], torch.where(sel_l, maxl[win], 1e9))
    return lo, hi


def dense_layout(points, mask, bank: BankTensors, order, draws,
                 cfg: SnowfallConfig, plane=None,
                 frame: int | None = None) -> DenseLayout:
    """Plane fit, noise floor and the phase-A layout of one padded scan
    (models/snowfall.py:468-885, Pallas branch); `frame` is the scan's
    index in a batch, for its span."""
    with span("snowfall.layout", frame):
        return _dense_layout(points, mask, bank, order, draws, cfg, plane)


def _dense_layout(points, mask, bank: BankTensors, order, draws,
                  cfg: SnowfallConfig, plane) -> DenseLayout:
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
    counts = bank.count
    feats = point_features(sx, sy, sz, cfg.beam_divergence_rad).contiguous()
    i32 = torch.int32
    head = (feats, (w0 // blk).to(i32), row_of_chunk.to(i32))
    tail = (counts.to(i32), bank.data_t, bank.wide_t)
    k_occ = cfg.max_occluders

    # A2 and A3 where the JAX package takes them (models/snowfall.py:
    # 504-524); its XLA branch, for a bank row shorter than the widened
    # slice, takes neither
    gsz = cfg.band_group
    grouped = blk % gsz == 0 and k_ext >= w_pallas
    band = cfg.band_width if (
        grouped and 0 < 2 * cfg.band_width <= w_pallas
    ) else 0
    band_r = cfg.route_band if (
        grouped and not band and 0 < cfg.route_band <= w_pallas
    ) else 0
    cover_mask = None
    if band or band_r:
        g_dim = blk // gsz
        lo_row = w0[:, None] + torch.arange(g_dim, device=dev) * gsz
        has = alive[:, None] & (
            torch.maximum(lo_row, start_c[:, None])
            < torch.minimum(lo_row + gsz, end_c[:, None])
        )                                               # (n_chunks, G)
        g_lo, g_hi = group_az_bounds(sx, sy, s_key, w0_raw, ch_of_chunk,
                                     gsz, g_dim)
        min_az = torch.where(has, g_lo, float("inf"))
        max_az = torch.where(has, g_hi, -float("inf"))
        lo_raw, hi_req = _lut_bounds(bank, row_of_chunk[:, None], min_az,
                                     max_az, delta)
        # the chunk's slice is anchored on the hull of its groups, as A1's
        lo_c_raw, hi_c_req = _lut_bounds(bank, row_of_chunk,
                                         min_az.amin(dim=1),
                                         max_az.amax(dim=1), delta)
        lo_c = (lo_c_raw.clamp(0, k_ext - w_pallas) // 128) * 128
        cnt_c = counts[row_of_chunk]
        chunk_unc = (cnt_c > w_pallas) & (hi_c_req > lo_c + w_pallas)
        window_overflow = torch.where(
            chunk_unc, (hi_c_req - (lo_c + w_pallas)).clamp_min(0), 0
        ).sum()
        cnt_g = cnt_c[:, None]
        lo_c1 = lo_c[:, None]
        # only the first wide_capacity wide columns can hold particles
        wide_sl = min(bank.wide_t.shape[2],
                      max(32, -(-cfg.wide_capacity // 32) * 32))
    if band:
        # two bands per group, both inside the chunk's slice: A aligned
        # down from the group's first column, B ending at or past its last
        lo_a = (lo_raw.clamp(0, k_ext - band) // 128) * 128
        lo_b = (-torch.div(band - hi_req, 128, rounding_mode="floor")
                * 128).clamp(0, k_ext - band)
        lo_a = lo_a.clamp(lo_c1, lo_c1 + (w_pallas - band))
        lo_b = lo_b.clamp(lo_c1, lo_c1 + (w_pallas - band))
        # a beam is uncovered only if both checks say so: the hull check
        # cannot see an azimuth gap, the kernel's angle check an empty
        # window (models/snowfall.py:773-789)
        hull_unc = (cnt_g > band) & (hi_req > lo_a + band)
        cover_mask = (
            valid_blk.reshape(n_chunks, g_dim, gsz) & hull_unc[:, :, None]
        ).reshape(n_chunks, blk)
        kernel = "A3"
        args = (*head, lo_a.reshape(-1).to(i32), lo_b.reshape(-1).to(i32),
                *tail)
        kw = dict(blk=blk, k_occ=k_occ, band=band, group=gsz,
                  wide_sl=wide_sl, delta=delta)
    elif band_r:
        # one band per group aligned down from its first column, inside the
        # chunk's slice; the upper clamp floors to 128 for any band width
        lo_a = (lo_raw.clamp(0, k_ext - band_r) // 128) * 128
        lo_a = lo_a.clamp(lo_c1, lo_c1 + ((w_pallas - band_r) // 128) * 128)
        # a chunk is fast when every live group's conservative window lies
        # in its band (or the band holds a whole wrap period) and the
        # chunk's own slice is covered; the deficit summed below is then 0
        # by construction and guards the routing itself
        fits_g = ~has | (cnt_g <= band_r) | (hi_req <= lo_a + band_r)
        fits = fits_g.all(dim=1) & ~chunk_unc
        mode = torch.where(has.any(dim=1), torch.where(fits, 2, 1), 0)
        window_overflow = window_overflow + torch.where(
            has & fits[:, None] & (cnt_g > band_r),
            (hi_req - (lo_a + band_r)).clamp_min(0), 0,
        ).sum()
        kernel = "A2"
        args = (*head, lo_c.to(i32), lo_a.reshape(-1).to(i32), mode.to(i32),
                *tail)
        kw = dict(blk=blk, w_sl=w_pallas, k_occ=k_occ, band=band_r,
                  group=gsz, wide_sl=wide_sl)
    else:
        a_lo = torch.maximum(w0, start_c)
        a_hi = torch.minimum(w0 + blk, end_c)
        has = alive & (a_lo < a_hi)
        # azimuth ascends within a channel, so a window's bounds are its
        # first and last in-channel rows, recomputed with the sort key's
        # atan2
        ia = a_lo.clamp(0, n_pad - 1)
        ib = (a_hi - 1).clamp(0, n_pad - 1)
        min_az = torch.where(has, torch.atan2(sy[ia], sx[ia]), float("inf"))
        max_az = torch.where(has, torch.atan2(sy[ib], sx[ib]),
                             -float("inf"))
        lo_raw, hi_req = _lut_bounds(bank, row_of_chunk, min_az, max_az,
                                     delta)
        lo = lo_raw.clamp(0, max(k_ext - w_pallas, 0))
        lo = (lo // 128) * 128
        # a slice at least count wide covers one wrap period = every
        # particle, so only count > w_pallas can under-cover
        uncovered = counts[row_of_chunk] > w_pallas
        window_overflow = torch.where(
            has & uncovered, (hi_req - (lo + w_pallas)).clamp_min(0), 0
        ).sum()
        kw = dict(blk=blk, w_sl=w_pallas, k_occ=k_occ)
        # A4b, then A4a, then A1 (models/snowfall.py:702-716); A4a and A4b
        # take no has gate
        if cfg.pallas_pair and n_chunks % 2 == 0:
            kernel = "A4b"
        elif cfg.pallas_transposed and not cfg.pallas_pair:
            kernel = "A4a"
        else:
            kernel = "A1"
        args = (*head, lo.to(i32), *tail) if kernel != "A1" else (
            *head, lo.to(i32), has.to(i32), *tail)

    return DenseLayout(
        n=n, n_pad=n_pad, n_chunks=n_chunks, blk=blk, bpc1=bpc1,
        xyz=xyz, intensity=intensity, mask=mask, noise_at=noise_at,
        sorted_cols=cols, sperm=perm, valid_blk=valid_blk,
        rank_flat=rank_blk.reshape(-1),
        channel_overflow=channel_overflow, window_overflow=window_overflow,
        kernel=kernel, occluder_args=args, occluder_kw=kw,
        slice_lo=lo_c if (band or band_r) else lo, cover_mask=cover_mask,
    )


def run_phase_a(lay: DenseLayout, frame: int | None = None):
    """Phase A on the layout's kernel. Returns (a12d, ovf,
    window_overflow): A3 adds to the layout's count the beams its coverage
    plane flags among `cover_mask`."""
    with span("snowfall.phase_a", frame):
        if lay.kernel == "A3":
            a12d, ovf, unc = find_occluders_banded(*lay.occluder_args,
                                                   **lay.occluder_kw)
            return a12d, ovf, lay.window_overflow + torch.where(
                lay.cover_mask, unc, 0
            ).sum()
        run = dict(A1=find_occluders, A2=find_occluders_routed,
                   A4a=find_occluders_t, A4b=find_occluders_pair)[lay.kernel]
        a12d, ovf = run(*lay.occluder_args, **lay.occluder_kw)
        return a12d, ovf, lay.window_overflow


def run_phase_a_folded(lays):
    """Phase A of B frames whose layouts all take kernel A1, in one A1
    launch (`find_occluders_folded`). Returns B triples as `run_phase_a`."""
    if any(lay.kernel != "A1" for lay in lays):
        raise ValueError("only A1 layouts fold")
    with span("snowfall.phase_a"):
        out = find_occluders_folded([lay.occluder_args for lay in lays],
                                    **lays[0].occluder_kw)
    return [(a12d, ovf, lay.window_overflow)
            for (a12d, ovf), lay in zip(out, lays)]


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
    pulse_kernel: str       # phase-C kernel: "C1" or "C2"
    pulse_args: tuple
    pulse_kw: dict          # C2's also holds blk, the pulse-block width


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
    # C2 where the pulse blocks pair up (models/snowfall.py:1107-1145)
    pblk = next((b for b in (cfg.pulse_block, 512, 256, 64) if cap % b == 0),
                64)
    pair = cfg.pulse_pair and (cap // pblk) % 2 == 0
    return Compacted(
        cap=cap, count_bucketed=count_bucketed, cidx=cidx, c_ok=c_ok,
        c_xyz=c_xyz, c_int=c_int, c_orig=c_orig, c_d=c_d, c_lut=c_lut,
        occluder_overflow=occ_of, compact_overflow=compact_overflow,
        pulse_kernel="C2" if pair else "C1",
        pulse_args=(
            feats, c_a1, c_a2, c_rr.contiguous(), c_valid,
            torch.cos(phase * all_r), torch.sin(phase * all_r),
            torch.cos(gph), torch.sin(gph),
        ),
        pulse_kw=dict(
            beam_rad=cfg.beam_divergence_rad,
            ipm=float(cfg.intervals_per_meter), c_tau=c_tau,
            xsi_r1=cfg.xsi_r1, xsi_r2=cfg.xsi_r2,
            **(dict(blk=pblk) if pair else {}),
        ),
    )


def run_phase_c(comp: Compacted):
    """Phase C on the compaction's kernel."""
    run = pulse_peaks_pair if comp.pulse_kernel == "C2" else pulse_peaks
    return run(*comp.pulse_args, **comp.pulse_kw)


def scatter_back(lay: DenseLayout, comp: Compacted, pulse_out,
                 cfg: SnowfallConfig, window_overflow) -> SnowfallResult:
    """Decision tail (simulation.py:151-192) and phase D, the touched-only
    scatter back to the original order (models/snowfall.py:1155-1325).
    `window_overflow` is phase A's count (`run_phase_a`)."""
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
        window_overflow=window_overflow.to(i32),
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
    return finish_scan(lay, *run_phase_a(lay), calib, cfg)


def finish_scan(lay: DenseLayout, a12d, ovf, window_overflow,
                calib: CalibTensors, cfg: SnowfallConfig,
                frame: int | None = None) -> SnowfallResult:
    """Phases B, C and D of one scan after its phase A (`run_phase_a`);
    `frame` as `dense_layout`'s."""
    with span("snowfall.compact", frame):
        comp = compact_occluded(lay, a12d, ovf, calib, cfg)
    with span("snowfall.phase_c", frame):
        pulse_out = run_phase_c(comp)
    with span("snowfall.scatter", frame):
        return scatter_back(lay, comp, pulse_out, cfg, window_overflow)


def grown_config(cfg: SnowfallConfig, name: str, k_ext: int,
                 num_lasers: int):
    """The config with the capacity behind overflow counter `name`
    doubled, or None when nothing can grow (the JAX package's healers,
    models/snowfall.py:1358-1402). The window assembly's window_overflow
    grows nothing: its window_size is the bank's own."""
    if name == "window_overflow":
        if cfg.assembly != "dense":
            return None
        new = {}
        if cfg.band_width:
            nb = min(cfg.band_width * 2, (k_ext // 128) * 128)
            if nb > cfg.band_width:
                new["band_width"] = nb
        if cfg.slice_width < k_ext:
            new["slice_width"] = min(cfg.slice_width * 2, k_ext)
        if not new:
            return None
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
    """Host wrapper: pads, runs the assembly `cfg.assembly` names on
    `device`, grows any overflowed capacity and reruns, compacts. Mirrors
    the reference's `augment(pc, ...) -> (stats, aug_pc)` contract.

    The default config is the JAX package's, `SnowfallConfig()`: the window
    assembly (kernels W1 and W2 on the card), whose rows come back in
    channel-sorted order and whose window_overflow raises. A dense config
    runs kernels A1-C2 and returns the rows in the original order; on a
    scan already stable-sorted by channel the two outputs are equal.
    """

    bank: ParticleBank
    calib: SensorCalib
    cfg: SnowfallConfig = SnowfallConfig()
    seed: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._bank = bank_to_torch(self.bank, self.device)
        self._calib = calib_to_torch(self.calib, self.device)
        self.last_result: SnowfallResult | None = None

    def __call__(self, pc, order=None, shuffle: bool = True):
        with span("augmenter.call"):
            return self._augment(pc, order, shuffle)

    def _augment(self, pc, order, shuffle: bool):
        dev = self.device
        with span("augmenter.pad"):
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
                torch.as_tensor(np.asarray(order), dtype=torch.int64,
                                device=dev),
                ransac_draws(self.seed, self.cfg.ransac_trials).to(dev),
            )
        for _attempt in range(8):
            res = snowfall_augment(*args, self.cfg)
            with span("augmenter.growth_check"):
                counts = {n: int(getattr(res, n)) for n in OVERFLOW_COUNTERS}
                overflowed = [n for n, c in counts.items() if c]
                if not overflowed:
                    break
                grown = self.cfg
                for name in overflowed:
                    grown = grown and grown_config(
                        grown, name, k_ext, self.calib.num_lasers
                    )
                if grown is None:
                    raise RuntimeError(
                        f"capacity overflow not auto-resolvable: {counts}"
                    )
                self.cfg = grown
                logger.warning("snowfall capacities grew after %s", counts)
        else:
            raise RuntimeError(
                f"capacity overflows persisted after growth: {counts}"
            )
        self.last_result = res
        with span("augmenter.compact"):
            stats = (
                int(res.num_attenuated),
                int(res.num_removed),
                int(res.avg_intensity_diff),
            )
            planes = res.planes.cpu().numpy()
            keep = res.keep.cpu().numpy()
            return stats, np.ascontiguousarray(planes.T[keep])
