"""Device-vs-oracle parity classification, shared by the CPU test harness
(tests/test_snowfall_parity.py) and the on-device parity tools
(the JAX package's tools/parity_tpu.py, the port's tools/parity_gpu.py).

Any device/oracle disagreement must sit ON a decision boundary where f32 and
f64 legitimately tie-break differently (simulation.py:151-192 decision
structure); anything else is a bug. The margin classifiers live in
oracle/snowfall.py; this module just drives them over a full scan.
"""

from __future__ import annotations

import numpy as np

from lidar_snow_sim_tpu_torch.oracle.snowfall import (
    _wrap_02pi,
    hit_set_margins,
    occlusion_dicts,
    pulse_decision_margins,
    resimulate_channel,
)

# decision-boundary tolerances (units documented per key); f64-vs-f32
# disagreements are legitimate only within these margins
DEFAULT_EPS = dict(
    peak_tie=1e-4,      # argmax near-tie between waveform bins
    range_margin=1e-3,  # |d_max - d_orig| vs the 0.2 m label cut [m]
    int_margin=1e-3,    # int() truncation edge [intensity counts]
    bin_margin=1e-4,    # ceil/floor pulse-bin edge [bin fractions]
    min_ratio=1e-5,     # an occluder claiming ~zero angular width
    cull=1e-3,          # particle range vs target range [m]
    tangency=1e-5,      # edge-line distance vs particle radius [m]
    angle=1e-6,         # particle azimuth vs beam limit [rad]
)


def classify_parity(
    pc,
    got,
    sets,
    calib,
    order,
    beam_div_deg: float,
    eps: dict | None = None,
    xyz_tol: float = 0.05,
    int_tol: float = 1.0,
):
    """Compare device output `got` (n, 5) against the channel-level oracle.

    pc must be channel-sorted (so rows align 1:1 with the device's stable
    sort). Returns a dict with total point count, the list of mismatching
    rows, and the subset whose margins put them on NO known decision
    boundary (real bugs)."""
    eps = eps or DEFAULT_EPS
    beam_rad = np.radians(beam_div_deg)
    mismatches, unexplained = [], []
    total = 0
    for channel in range(calib.num_lasers):
        m = pc[:, 4] == channel
        if not m.any():
            continue
        cpc = pc[m].astype(np.float64)
        d = np.linalg.norm(cpc[:, :3], axis=1)
        center = _wrap_02pi(np.arctan2(cpc[:, 1], cpc[:, 0]))
        beams = np.column_stack(
            [_wrap_02pi(center - beam_rad / 2),
             _wrap_02pi(center + beam_rad / 2)]
        )
        occl = occlusion_dicts(beams, d, sets[order[channel]], beam_div_deg)
        _, want = resimulate_channel(
            cpc, occl, channel,
            float(calib.min_intensity[channel]),
            float(calib.focal_distance[channel]),
            float(calib.focal_slope[channel]),
        )
        have = got[m]
        total += len(want)
        bad = np.where(
            (have[:, 4] != want[:, 4])
            | (np.abs(have[:, 3] - np.round(want[:, 3])) > int_tol)
            | (np.abs(have[:, :3] - want[:, :3]).max(axis=1) > xyz_tol)
        )[0]
        for j in bad:
            margins = pulse_decision_margins(
                d[j], cpc[j, 3], occl[j], channel,
                float(calib.min_intensity[channel]),
                float(calib.focal_distance[channel]),
                float(calib.focal_slope[channel]),
            )
            margins.update(
                hit_set_margins(
                    cpc[j, :3], d[j], beams[j, 0], beams[j, 1],
                    sets[order[channel]],
                )
            )
            on_boundary = any(margins[k] < e for k, e in eps.items())
            rec = dict(
                channel=int(channel), row=int(j),
                want_label=int(want[j, 4]), have_label=int(have[j, 4]),
                margins={k: float(v) for k, v in margins.items()},
            )
            mismatches.append(rec)
            if not on_boundary:
                unexplained.append(rec)
    return dict(
        total=int(total),
        mismatches=mismatches,
        unexplained=unexplained,
        mismatch_rate=(len(mismatches) / total) if total else 0.0,
    )
