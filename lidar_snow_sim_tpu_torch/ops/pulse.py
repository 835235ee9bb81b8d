"""Phase C of the dense snowfall assembly: first-claim sweep and received
pulse peak per occluded beam (counterpart of
`lidar_snow_sim_tpu/ops/pallas_pulse.py`).

`pulse_peaks` launches kernel C1 (`csrc/pulse.cu`) on CUDA tensors and
runs `pulse_plain`, the same function in plain torch, on CPU tensors;
`pulse_peaks_pair` (the `pulse_pair` knob) does the same with kernel C2,
C1's body with one beam of each of two pulse blocks per warp (TPU
`_kernel_pair`, pallas_pulse.py:244), which computes the same values. All follow the
arithmetic of the TPU kernel `_kernel` (pallas_pulse.py:173):

1. the sweep: extract-min over the 2K+2 interval endpoints, each trip
   retiring every copy of the minimum, the lowest-index covering occluder
   claiming [prev, cur];
2. amplitudes amp_scale * share * xsi(r) / r^2 (the unclaimed remainder
   goes to the hard target);
3. the waveform over the M-bin grid, summed bin by bin as target bump, then
   occluder bumps 0, 1, 2, ...; a bump covers r * ipm <= bin <=
   (r + c_tau) * ipm with pulse 0.5 * (1 - (cos_g * cb + sin_g * sb));
4. the peak and its first bin.

`window_pulse_peaks` launches kernel W2 (`csrc/pulse.cu`), the window
assembly's sweep, bump selection and pulse peak, which the JAX package
leaves to XLA (models/snowfall.py:151-199); `window_pulse_plain` is its
plain version. Its inputs and outputs are per point, (N, K) and (N,).

C1's and C2's inputs are K-outer: feats (4, cap) rows [d_orig, right, left,
0.9 * max_intensity]; a1, a2, rr, valid (K, cap); cos_b, sin_b (K+1, cap),
row K the hard target; cos_g, sin_g (M,). Outputs (cap,) each: peak f32,
first peak bin int32, touched bool (the kernels write it as one byte a
beam), remainder f32.
"""

from __future__ import annotations

import math

import torch

from lidar_snow_sim_tpu_torch import _kernels
from lidar_snow_sim_tpu_torch.config import SPEED_OF_LIGHT
from lidar_snow_sim_tpu_torch.ops.f32 import div
from lidar_snow_sim_tpu_torch.ops.geometry import TWO_PI, beam_limits, norm3
from lidar_snow_sim_tpu_torch.ops.sweep import occlusion_sweep
from lidar_snow_sim_tpu_torch.ops.waveform import waveform_peak, xsi

BIG = 3.0e38
_CHUNK = 512    # beams per waveform step of the plain version (bounds memory)


def claimed_widths(feats, a1, a2, valid):
    """The first-claim sweep of the plain version: (claimed (K, cap), the
    width each occluder claims; unclaimed (cap,), the hard target's). Its
    trip count is the maximum over all beams; the extra trips add exact
    zeros."""
    k_occ, cap = a1.shape
    dev = feats.device
    right, left = feats[1], feats[2]
    wrapped = right > left
    right_u = torch.where(wrapped, right - TWO_PI, right)
    vb = valid > 0.5
    a1 = torch.where(wrapped & (a1 > a2), a1 - TWO_PI, a1)
    a1 = torch.where(vb, a1, left)
    a2 = torch.where(vb, a2, left)

    score = torch.cat([right_u[None], left[None], a1, a2], dim=0)
    n_valid = vb.sum(dim=0)
    trips = min(2 * int(n_valid.max()) + 3, 2 * k_occ + 2) if cap else 0
    row_k = torch.arange(k_occ, device=dev)[:, None]
    prev = torch.zeros(cap, device=dev)
    claimed = torch.zeros((k_occ, cap), device=dev)
    unclaimed = torch.zeros(cap, device=dev)
    for k in range(trips):
        cur = score.min(dim=0).values
        live = cur < BIG / 2
        width = torch.where(live & (k > 0), cur - prev, 0.0)
        mid = 0.5 * (cur + prev)
        cover = (a1 <= mid) & (mid <= a2) & vb
        widx = torch.where(cover, row_k, k_occ).min(dim=0).values
        claimed = claimed + torch.where(row_k == widx, width, 0.0)
        unclaimed = unclaimed + torch.where(widx >= k_occ, width, 0.0)
        score = torch.where(score == cur, BIG, score)
        prev = torch.where(live, cur, prev)
    return claimed, unclaimed


def bump_amplitudes(feats, a1, a2, rr, valid, *, beam_rad: float,
                    xsi_r1: float, xsi_r2: float):
    """The sweep's shares as bumps: (rr_all (K+1, cap), each bump's range,
    row K the hard target; amp (K+1, cap); last_active (K, cap), b + 1
    where occluder b claims a share, else 0; touched (cap,); remainder
    (cap,))."""
    k_occ = a1.shape[0]
    d_orig, amp_scale = feats[0], feats[3]
    claimed, unclaimed = claimed_widths(feats, a1, a2, valid)
    row_k = torch.arange(k_occ, device=feats.device)[:, None]
    ratio = torch.clamp(div(claimed, beam_rad), 0.0, 1.0)
    remainder = torch.clamp(div(unclaimed, beam_rad), 0.0, 1.0)
    touched = (claimed > 0.0).any(dim=0)
    rr_all = torch.cat([rr, d_orig[None]], dim=0)             # (K+1, cap)
    share = torch.cat([ratio, remainder[None]], dim=0)
    r_amp = torch.clamp(rr_all, 1e-6, 1e6)
    xsi = torch.clamp(div(r_amp - xsi_r1, xsi_r2 - xsi_r1), 0.0, 1.0)
    amp = amp_scale * share * xsi / (r_amp * r_amp)
    last_active = torch.where(ratio > 0.0, row_k + 1, 0)     # (K, cap)
    return rr_all, amp, last_active, touched, remainder


def pulse_windows(rr_all, amp, last_active, *, ipm: float, c_tau: float,
                  m_bins: int):
    """The bins kernel C1's windowed waveform evaluates (csrc/pulse.cu).

    A bump covers the bins r * ipm <= bin <= (r + c_tau) * ipm; every term
    outside its window, and every term of a zero amplitude, is an exact
    zero, and a bin that no other term reaches is +0.0. So the waveform is
    evaluated on the union of the target's window (row K) and the windows
    of the occluder bumps before the beam's last active one with a nonzero
    amplitude, and the peak is the larger of its peak there and +0.0 at the
    lowest bin outside the union, ties to the lower bin. Returns the
    windows' bins as (lo, hi) (K+1, cap) int64, clamped to [0, m_bins - 1],
    empty (lo > hi) for a bump the waveform skips."""
    k_occ = amp.shape[0] - 1
    n_active = last_active.amax(dim=0)                        # (cap,)
    row = torch.arange(k_occ + 1, device=amp.device)[:, None]
    walked = (row == k_occ) | ((row < n_active) & (amp != 0.0))
    lo = torch.ceil(rr_all * ipm).clamp(0, m_bins)
    hi = torch.floor((rr_all + c_tau) * ipm).clamp(-1, m_bins - 1)
    lo = torch.where(walked, lo, m_bins).long()
    hi = torch.where(walked, hi, -1).long()
    return lo, hi


def windowed_peak(feats, a1, a2, rr, valid, cos_b, sin_b, cos_g, sin_g, *,
                  beam_rad: float, ipm: float, c_tau: float, xsi_r1: float,
                  xsi_r2: float):
    """The (peak, first bin) of the windowed rule, `pulse_windows`, in
    plain torch: the waveform summed only over the walked bumps, on the
    bins of their windows' union, and +0.0 at the lowest bin outside it.
    Equals `pulse_plain`'s (up to the sign of a zero peak)."""
    m_bins = cos_g.shape[0]
    rr_all, amp, last_active, _, _ = bump_amplitudes(
        feats, a1, a2, rr, valid, beam_rad=beam_rad, xsi_r1=xsi_r1,
        xsi_r2=xsi_r2)
    lo, hi = pulse_windows(rr_all, amp, last_active, ipm=ipm, c_tau=c_tau,
                           m_bins=m_bins)
    bins = torch.arange(m_bins, device=feats.device)[:, None]   # (M, 1)
    binf = bins.to(torch.float32)
    covered = torch.zeros((m_bins, amp.shape[1]), dtype=torch.bool,
                          device=feats.device)
    wave = torch.zeros((m_bins, amp.shape[1]), device=feats.device)
    for b in [amp.shape[0] - 1, *range(amp.shape[0] - 1)]:   # target first
        walked = lo[b] <= hi[b]
        covered |= (bins >= lo[b]) & (bins <= hi[b])
        r = rr_all[b]
        window = (binf >= r * ipm) & (binf <= (r + c_tau) * ipm)
        pulse = 0.5 * (1.0 - (cos_g[:, None] * cos_b[b] + sin_g[:, None]
                              * sin_b[b]))
        wave = wave + torch.where(window & walked, amp[b] * pulse, 0.0)
    wave = torch.where(covered, wave, 0.0)
    peak = wave.max(dim=0).values
    first = torch.where(wave == peak, bins, m_bins).min(dim=0).values
    return peak, first.to(torch.int32)


def pulse_plain(feats, a1, a2, rr, valid, cos_b, sin_b, cos_g, sin_g, *,
                beam_rad: float, ipm: float, c_tau: float, xsi_r1: float,
                xsi_r2: float):
    """Plain torch version of kernel C1, the waveform _CHUNK beams at a
    time. Trip counts are maxima over all beams (the sweep) or over the
    chunk (the bumps); the extra trips add exact zeros."""
    k_occ, cap = a1.shape
    m_bins = cos_g.shape[0]
    dev = feats.device
    rr_all, amp, last_active, touched, remainder = bump_amplitudes(
        feats, a1, a2, rr, valid, beam_rad=beam_rad, xsi_r1=xsi_r1,
        xsi_r2=xsi_r2)

    bins = torch.arange(m_bins, device=dev)
    binf = bins.to(torch.float32)[:, None]
    cg, sg = cos_g[:, None], sin_g[:, None]
    peak = torch.empty(cap, device=dev)
    first = torch.empty(cap, dtype=torch.int32, device=dev)
    for c0 in range(0, cap, _CHUNK):
        sl = slice(c0, min(c0 + _CHUNK, cap))

        def bump(b):
            r = rr_all[b, sl]
            window = (binf >= r * ipm) & (binf <= (r + c_tau) * ipm)
            pulse = 0.5 * (1.0 - (cg * cos_b[b, sl] + sg * sin_b[b, sl]))
            return torch.where(window, amp[b, sl] * pulse, 0.0)   # (M, n)

        wave = bump(k_occ)
        for b in range(int(last_active[:, sl].max())):
            wave = wave + bump(b)
        pk = wave.max(dim=0).values
        peak[sl] = pk
        first[sl] = torch.where(
            wave == pk, bins[:, None], m_bins
        ).min(dim=0).values.to(torch.int32)
    return peak, first, touched, remainder


def _launch(entry: str, what: str, extra: tuple, feats, a1, a2, rr, valid,
            cos_b, sin_b, cos_g, sin_g, *, beam_rad: float, ipm: float,
            c_tau: float, xsi_r1: float, xsi_r2: float):
    """Check the inputs and launch `entry` of csrc/pulse.cu; `extra` are
    its int arguments after cap, K and M."""
    k_occ, cap = a1.shape
    m_bins = cos_g.shape[0]
    for name, t, shape in (
        ("feats", feats, (4, cap)), ("a1", a1, (k_occ, cap)),
        ("a2", a2, (k_occ, cap)), ("rr", rr, (k_occ, cap)),
        ("valid", valid, (k_occ, cap)), ("cos_b", cos_b, (k_occ + 1, cap)),
        ("sin_b", sin_b, (k_occ + 1, cap)), ("cos_g", cos_g, (m_bins,)),
        ("sin_g", sin_g, (m_bins,)),
    ):
        _kernels.check_input(name, t, torch.float32, shape)
    dev = feats.device
    peak = torch.empty(cap, dtype=torch.float32, device=dev)
    idx = torch.empty(cap, dtype=torch.int32, device=dev)
    touched = torch.empty(cap, dtype=torch.bool, device=dev)
    remainder = torch.empty(cap, dtype=torch.float32, device=dev)
    err = _kernels.launch(
        dev, getattr(_kernels.load("pulse"), entry),
        feats.data_ptr(), a1.data_ptr(), a2.data_ptr(), rr.data_ptr(),
        valid.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
        cos_g.data_ptr(), sin_g.data_ptr(), peak.data_ptr(), idx.data_ptr(),
        touched.data_ptr(), remainder.data_ptr(), cap, k_occ, m_bins, *extra,
        beam_rad, ipm, c_tau, xsi_r1, xsi_r2 - xsi_r1,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(err, f"{what} ({entry})")
    return peak, idx, touched, remainder


def pulse_peaks(*args, **kw):
    """Phase C: kernel C1 on CUDA tensors, its plain version on CPU
    tensors. Arguments as `pulse_plain`; returns (peak, idx, touched,
    remainder), each (cap,). C1 needs what phase A's top-K gives: in each
    beam the valid occluders' ranges `rr` rise with their slot and none
    exceeds the target's d_orig (feats row 0)."""
    if args[0].device.type == "cpu":
        return pulse_plain(*args, **kw)
    out = _launch("pulse_c1", "kernel C1", (), *args, **kw)
    pulse_peaks.launches += 1
    return out


def pulse_peaks_pair(*args, blk: int, **kw):
    """Phase C on kernel C2 (CUDA tensors): C1's body, with beam j of
    pulse blocks 2i and 2i + 1 of `blk` beams in one warp, so cap must be
    a multiple of 2 * blk. Its plain version is C1's, `pulse_plain` (CPU
    tensors). As `pulse_peaks` otherwise, C1's precondition included: in
    each beam the valid occluders' ranges `rr` rise with their slot and
    none exceeds the target's d_orig (feats row 0)."""
    cap = args[1].shape[1]
    if blk <= 0 or cap % (2 * blk):
        raise ValueError(f"kernel C2 needs cap ({cap}) to be a multiple of "
                         f"2 * blk ({blk})")
    if args[0].device.type == "cpu":
        return pulse_plain(*args, **kw)
    out = _launch("pulse_c2", "kernel C2", (blk,), *args, **kw)
    pulse_peaks_pair.launches += 1
    return out


def window_pulse_plain(xyz, max_int, occ_a1, occ_a2, occ_dist, occ_valid,
                       range_grid, *, beam_rad: float, ipm: int,
                       tau_h: float, max_bumps: int):
    """Plain torch version of kernel W2 (the JAX package's `_pulse_phase`
    up to the waveform's peak, models/snowfall.py:172-199) for P points with
    their occluders (P, K) from `occluders_window_plain`: the first-claim
    sweep (`ops/sweep.occlusion_sweep`), the max_bumps largest nonzero
    ratios (lax.top_k's order: ties by column, zeros fill the tail), the
    amplitudes 0.9 * max_int * ratio * xsi(r) / r^2 with the hard target
    last, and the summed waveform's peak (`ops/waveform.waveform_peak`).

    Returns four (P,) tensors: the peak (f32), its first bin (int32),
    touched (bool) and bump_overflow (int32: the count of nonzero ratios
    beyond max_bumps). A point at the origin has a NaN target amplitude
    (0/0), so peak NaN and bin M.
    """
    d_orig = norm3(xyz)
    right, left = beam_limits(xyz[:, 0], xyz[:, 1], beam_rad)
    ratio, remainder, touched = occlusion_sweep(right, left, occ_a1, occ_a2,
                                                occ_valid, beam_rad)
    bump_overflow = ((ratio > 0).sum(dim=1) - max_bumps).clamp_min(0)
    bump_ratio, bump_idx = torch.sort(ratio, dim=1, descending=True,
                                      stable=True)
    bump_ratio = bump_ratio[:, :max_bumps]
    bump_r = occ_dist.gather(1, bump_idx[:, :max_bumps])
    # every amplitude, the hard target's included, takes the snowflake
    # scale 0.9 * max_intensity (the reference's CA_P0 carry-over)
    amp_scale = 0.9 * max_int
    bump_amp = amp_scale[:, None] * bump_ratio * xsi(bump_r) / (
        bump_r * bump_r)
    bump_amp = torch.where(bump_ratio > 0, bump_amp, 0.0)
    tgt_amp = amp_scale * remainder * xsi(d_orig) / (d_orig * d_orig)
    peak, idx = waveform_peak(
        torch.cat([bump_r, d_orig[:, None]], dim=1),
        torch.cat([bump_amp, tgt_amp[:, None]], dim=1),
        range_grid, ipm, tau_h)
    return (peak, idx.to(torch.int32), touched.any(dim=1),
            bump_overflow.to(torch.int32))


def window_pulse_peaks(xyz, max_int, occ_a1, occ_a2, occ_dist, occ_valid,
                       range_grid, *, beam_rad: float, ipm: int,
                       tau_h: float, max_bumps: int):
    """Kernel W2 on CUDA tensors, `window_pulse_plain` on CPU tensors;
    arguments and outputs as `window_pulse_plain`."""
    if xyz.device.type == "cpu":
        return window_pulse_plain(xyz, max_int, occ_a1, occ_a2, occ_dist,
                                  occ_valid, range_grid, beam_rad=beam_rad,
                                  ipm=ipm, tau_h=tau_h, max_bumps=max_bumps)
    return launch_w2(w2_inputs(xyz, max_int, occ_a1, occ_a2, occ_dist,
                               occ_valid, range_grid, beam_rad=beam_rad,
                               tau_h=tau_h),
                     beam_rad=beam_rad, ipm=ipm, tau_h=tau_h,
                     max_bumps=max_bumps)


def w2_inputs(xyz, max_int, occ_a1, occ_a2, occ_dist, occ_valid,
              range_grid, *, beam_rad: float, tau_h: float) -> tuple:
    """Kernel W2's arrays, with the transcendentals made by torch as
    `window_pulse_plain` makes them: feats (4, P) rows [d_orig, right,
    left, 0.9 * max_int]; W1's four (P, K) rows; cos and sin of each slot's
    pulse phase (P, K), of the target's (P,) and of the grid's (M,)."""
    phase = 2.0 * math.pi / (SPEED_OF_LIGHT * tau_h)   # as waveform_peak
    d_orig = norm3(xyz)
    right, left = beam_limits(xyz[:, 0], xyz[:, 1], beam_rad)
    beta, beta_t, gph = phase * occ_dist, phase * d_orig, phase * range_grid
    return (torch.stack([d_orig, right, left, 0.9 * max_int]), occ_a1,
            occ_a2, occ_dist, occ_valid, torch.cos(beta), torch.sin(beta),
            torch.cos(beta_t), torch.sin(beta_t), torch.cos(gph),
            torch.sin(gph))


def launch_w2(inputs: tuple, *, beam_rad: float, ipm: int, tau_h: float,
              max_bumps: int):
    """Launch kernel W2 on `w2_inputs`' arrays (CUDA tensors) and count
    the launch; returns (peak, first bin, touched, bump_overflow)."""
    n, k_occ = inputs[1].shape
    m_bins = inputs[-1].shape[0]
    names = ("feats", "occ_a1", "occ_a2", "occ_dist", "occ_valid", "cos_b",
             "sin_b", "cos_t", "sin_t", "cos_g", "sin_g")
    shapes = ((4, n), *[(n, k_occ)] * 6, (n,), (n,), (m_bins,), (m_bins,))
    for name, t, shape in zip(names, inputs, shapes):
        _kernels.check_input(name, t, torch.bool if name == "occ_valid"
                             else torch.float32, shape)
    dev = inputs[0].device
    peak = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    touched = torch.empty(n, dtype=torch.bool, device=dev)
    bump_overflow = torch.empty(n, dtype=torch.int32, device=dev)
    # xsi's ramp as ops/waveform.xsi's defaults, which the plain version
    # takes
    err = _kernels.launch(
        dev, _kernels.load("pulse").pulse_w2,
        *(t.data_ptr() for t in inputs), peak.data_ptr(), idx.data_ptr(),
        touched.data_ptr(), bump_overflow.data_ptr(), n, k_occ, m_bins,
        max_bumps, beam_rad, float(ipm), SPEED_OF_LIGHT * tau_h, 0.9,
        1.0 - 0.9, torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(err, "kernel W2 (pulse_w2)")
    window_pulse_peaks.launches += 1
    return peak, idx, touched, bump_overflow


pulse_peaks.launches = 0
pulse_peaks_pair.launches = 0
window_pulse_peaks.launches = 0
