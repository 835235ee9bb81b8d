"""The work a frame's snowfall needs, counted from the frame's inputs
(scan, particle sets, channel order) and the configuration's semantics,
whatever kernel does it; and the least time the card could take for it.

Two phases, the same for the dense assembly (kernels A1, C1) and the
window assembly (kernels W1, W2):

- occluders (A1, W1): each live point is tested against the candidates
  its angular window holds, the narrow particles of its bank row whose
  azimuth lies within beam/2 + wide_threshold of its own (at most
  window_size) and the row's wide particles. Operations: HIT_TEST_OPS a
  test. Bytes, each read or written once: the live points (x, y, z and
  the channel: 16 B), the distinct particles any window holds (x, y, r:
  12 B), the wide particles of the rows read (12 B), and the output: each
  point's hits up to max_occluders (a1, a2, range: 12 B) and its count
  (4 B).
- pulse (C1, W2): each point with a hit runs the first-claim sweep over
  its nv = min(hits, max_occluders) intervals, (2nv + 2)^2 compares to
  rank the endpoints and 2nv(2nv + 1) cover tests, a cos and sin pair
  (TRIG_OPS) for each of its min(nv, max_bumps) bumps and its target,
  and WAVE_OPS for each waveform bin each of them covers. Bytes: its hits
  read (12 B each), its range, edges and calibration read (16 B), its
  peak, bin, label and overflow written (16 B).

A hit is a particle nearer than the point whose disk reaches into the
beam: its azimuth within beam/2 plus its own angular half-width
asin(r / d) of the point's. A hit whose share of the beam is claimed by
nearer hits still counts as a bump: the count stands above the work the
data needs by those. No count depends on how a kernel lays out, stages or
re-reads its inputs.
"""

from __future__ import annotations

import numpy as np

FP32_FLOPS = 67e12   # NVIDIA H100 SXM, float32 outside the tensor cores
HBM_BYTES = 3.35e12  # its HBM3 bandwidth; both at the 700 W limit
HIT_TEST_OPS = 20    # one (point, candidate) test: range cull, two edge
#                      distances against the radius, the half-planes
WAVE_OPS = 9         # one (bin, bump) term: phase, sin^2, scale, add
TRIG_OPS = 40        # one cos and sin pair of a bump's pulse phase
SPEED_OF_LIGHT = 299792458.0


def least_seconds(ops: float, n_bytes: float):
    """(seconds, "ops" or "bytes"): the larger of the operations over the
    float32 peak and the bytes over the memory bandwidth."""
    t_ops, t_bytes = ops / FP32_FLOPS, n_bytes / HBM_BYTES
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


class _Row:
    """One particle set as a window sees it: the narrow particles by
    signed azimuth, with copies one turn down and up, and the wide ones."""

    def __init__(self, particles, wide_threshold: float):
        p = np.asarray(particles, np.float64)
        x, y, r = p[:, 0], p[:, 1], p[:, 2]
        d = np.hypot(x, y)
        hw = np.arcsin(np.clip(r / np.maximum(d, 1e-12), 0.0, 1.0))
        wide = hw > wide_threshold
        ang = np.arctan2(y, x)
        srt = np.argsort(ang[~wide], kind="stable")
        self.k = int(srt.size)
        a, dd, h = ang[~wide][srt], d[~wide][srt], hw[~wide][srt]
        self.ang = np.concatenate([a - 2 * np.pi, a, a + 2 * np.pi])
        self.dist = np.tile(dd, 3)
        self.hw = np.tile(h, 3)
        self.wide_ang, self.wide_dist = ang[wide], d[wide]
        self.wide_hw = hw[wide]


def _hits(center, rng, half, ang, dist, hw):
    """Whether each (point, particle) pair is a hit."""
    da = np.abs(np.angle(np.exp(1j * (ang - center))))
    return (dist < rng) & (da <= half + hw)


def frame_work(scan, order, particle_sets, cfg: dict) -> dict:
    """{"occluders": (ops, bytes), "pulse": (ops, bytes)} of one frame.
    `cfg` holds the configuration's snowfall fields."""
    beam = np.radians(cfg["beam_divergence_deg"])
    half = beam / 2
    delta = half + cfg["wide_threshold"]
    window, k_occ, n_bumps = (cfg["window_size"], cfg["max_occluders"],
                              cfg["max_bumps"])
    ipm = cfg["intervals_per_meter"]
    c_tau = SPEED_OF_LIGHT * cfg["tau_h"]
    m_bins = int(np.ceil(cfg["lidar_range"] * ipm + c_tau * ipm))

    def bins(r):
        lo = np.maximum(np.ceil(r * ipm), 0)
        hi = np.minimum(np.floor((r + c_tau) * ipm), m_bins - 1)
        return np.maximum(hi - lo + 1, 0)

    pc = np.asarray(scan, np.float64)
    tests = parts = wide_read = 0
    hits_all = []
    pulse_ops = 0.0
    for row in np.unique(order[pc[:, 4].astype(np.int64)]):
        sel = order[pc[:, 4].astype(np.int64)] == row
        xyz = pc[sel, :3]
        center = np.arctan2(xyz[:, 1], xyz[:, 0])
        rng = np.linalg.norm(xyz, axis=1)
        bank = _Row(particle_sets[int(row)], cfg["wide_threshold"])
        lo = np.searchsorted(bank.ang, center - delta, "left")
        n = np.minimum(np.searchsorted(bank.ang, center + delta, "right")
                       - lo, window)
        n_wide = bank.wide_ang.size
        tests += int(n.sum()) + n_wide * len(xyz)
        wide_read += n_wide
        # distinct particles the windows hold (a copy is its particle)
        cover = np.zeros(bank.ang.size + 1, np.int64)
        np.add.at(cover, lo, 1)
        np.add.at(cover, lo + n, -1)
        held = np.nonzero(np.cumsum(cover[:-1]) > 0)[0]
        parts += np.unique(held % max(bank.k, 1)).size
        owner = np.repeat(np.arange(len(xyz)), n)
        col = np.repeat(lo, n) + (np.arange(int(n.sum()))
                                  - np.repeat(np.cumsum(n) - n, n))
        hit = _hits(center[owner], rng[owner], half, bank.ang[col],
                    bank.dist[col], bank.hw[col])
        nh = np.bincount(owner[hit], minlength=len(xyz))
        hit_d = [bank.dist[col][hit]]
        hit_o = [owner[hit]]
        if n_wide:
            ow = np.repeat(np.arange(len(xyz)), n_wide)
            j = np.tile(np.arange(n_wide), len(xyz))
            wh = _hits(center[ow], rng[ow], half, bank.wide_ang[j],
                       bank.wide_dist[j], bank.wide_hw[j])
            nh = nh + np.bincount(ow[wh], minlength=len(xyz))
            hit_d.append(bank.wide_dist[j][wh])
            hit_o.append(ow[wh])
        nv = np.minimum(nh, k_occ)
        occ = nv > 0
        hits_all.append(nv)
        # the bumps: each point's nearest min(nv, max_bumps) hits
        d_all, o_all = np.concatenate(hit_d), np.concatenate(hit_o)
        srt = np.lexsort((d_all, o_all))
        d_all, o_all = d_all[srt], o_all[srt]
        first = np.searchsorted(o_all, np.arange(len(xyz)))
        rank = np.arange(o_all.size) - first[o_all]
        bump = rank < np.minimum(nv, n_bumps)[o_all]
        terms = bins(d_all[bump]).sum() + bins(rng[occ]).sum()
        nb = np.minimum(nv, n_bumps)[occ]
        v = nv[occ].astype(np.float64)
        pulse_ops += float(((2 * v + 2) ** 2 + 2 * v * (2 * v + 1)).sum()
                           + terms * WAVE_OPS + (nb + 1).sum() * TRIG_OPS)
    nv = np.concatenate(hits_all)
    live = len(pc)
    n_hits, n_occ = int(nv.sum()), int((nv > 0).sum())
    occ_bytes = (live * 16 + (parts + wide_read) * 12 + n_hits * 12
                 + live * 4)
    pulse_bytes = n_hits * 12 + n_occ * 32
    return {"occluders": (float(tests * HIT_TEST_OPS), float(occ_bytes)),
            "pulse": (pulse_ops, float(pulse_bytes))}


def roofline_share(run, kernel: str, phase: str):
    """100 x the mean least time of `phase` over the frames of the traced
    window, over the mean time of a record of `kernel` there (one launch
    a frame); None where the window holds no such record."""
    if run.trace is None or not run.frames_traced:
        return None
    us = run.trace.kernel_us(kernel)
    if not us.size:
        return None
    least = [least_seconds(*run.work(f)[phase])[0] for f in run.frames_traced]
    return 100.0 * float(np.mean(least)) / (float(np.mean(us)) / 1e6)
