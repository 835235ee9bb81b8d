"""The plain reference of one frame: what the configuration's snowfall
gives a scan, worked out in float64 NumPy from the frame's own inputs
(scan, particle sets, calibration, channel order, RANSAC draws) and
nothing the port made. It imports numpy alone; the RANSAC draws are made
by the caller with a CPU torch generator (`port_bench/inputs.ransac_draws`).

A frame is worked out in three steps, so that its channels can be spread
over processes: `frame_floor` (sort, plane, noise floor), `snow_channels`
on groups of channels, `frame_result` (rounding, keep rule, stats).
"""

from __future__ import annotations

import numpy as np

from port_bench.reference.fitting import noise_floors, ransac_plane
from port_bench.reference.oracle import snow_channels


def frame_floor(scan, draws, *, noise_floor: float, fit_on_sorted: bool,
                rnd=None):
    """(perm, rows, thresholds): the scan stable-sorted by channel (row i
    is scan row perm[i]) as float64 rows, and the noise thresholds at each
    (`fitting.noise_floors`: the float64 floor first).
    `fit_on_sorted`: the plane's RANSAC picks its crop points in the
    channel-sorted order (the window assembly) or in the scan's own (the
    dense assembly)."""
    scan = np.asarray(scan)
    perm = np.argsort(scan[:, 4], kind="stable")
    pc = scan[perm].astype(np.float64)
    fit = pc.copy() if fit_on_sorted else scan.astype(np.float64)
    if rnd is not None:
        pc[:, :3] = rnd(pc[:, :3])
        fit[:, :3] = rnd(fit[:, :3])
    plane = ransac_plane(fit[:, :3], draws)
    thresholds = noise_floors(pc[:, :3], pc[:, 3], plane, noise_floor)
    return perm, pc, [t if rnd is None else rnd(t) for t in thresholds]


def frame_result(perm, pc, thresholds, parts) -> dict:
    """The frame's result from `parts`, one (channels, diff sum, rows) for
    each group of channels that covers it: {"perm", "rows": (N, 5) float64
    x, y, z, rounded intensity, label in the channel-sorted order, "keep":
    (N,) bool (a moved point, label 2, or an intensity over the noise
    floor), "stats": (num_attenuated, num_removed, avg_intensity_diff)},
    under the float64 noise floor, and "keeps" (V, N) and "stats_all",
    the same under each of the V floors of `thresholds`."""
    rows = pc.copy()
    diff_sum = 0.0
    for channels, ds, part in parts:
        rows[np.isin(pc[:, 4], channels)] = part
        diff_sum += ds
    rows[:, 3] = np.round(rows[:, 3])
    keeps, stats = [], []
    for threshold in thresholds:
        keep = (rows[:, 4] == 2) | (rows[:, 3] > threshold)
        n_att = int((rows[keep, 4] == 1).sum())
        keeps.append(keep)
        stats.append((n_att, int((~keep).sum()),
                      int(diff_sum / n_att) if n_att > 0 else 0))
    return dict(perm=perm, rows=rows, keep=keeps[0], stats=stats[0],
                keeps=np.stack(keeps), stats_all=stats)


def reference_frame(scan, particle_sets, calib, order, draws, *,
                    beam_divergence_deg: float, noise_floor: float,
                    fit_on_sorted: bool, rnd=None) -> dict:
    """`frame_result` of the whole frame, in this process."""
    perm, pc, thresholds = frame_floor(scan, draws, noise_floor=noise_floor,
                                       fit_on_sorted=fit_on_sorted, rnd=rnd)
    channels = np.arange(calib.num_lasers)
    ds, rows = snow_channels(pc, particle_sets, calib, order,
                             beam_divergence_deg, rnd, channels)
    return frame_result(perm, pc, thresholds, [(channels, ds, rows)])


def bfloat16(a):
    """`a` rounded to bfloat16 (8 significant bits, to nearest even),
    returned as float64."""
    f = np.asarray(a, np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)
