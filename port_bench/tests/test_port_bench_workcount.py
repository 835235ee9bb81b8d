"""The work counts against a frame counted by hand, and the roofline
shares built on them."""

from __future__ import annotations

import numpy as np
import pytest

from port_bench import workcount
from port_bench.trace import Trace

CFG = {"beam_divergence_deg": float(np.degrees(3e-3)), "wide_threshold": 5e-3,
       "window_size": 256, "max_occluders": 2, "max_bumps": 1,
       "intervals_per_meter": 10, "tau_h": 1e-8, "lidar_range": 120.0}

# point A on the x axis at 20 m, B on the y axis at 30 m, both channel 0
SCAN = np.array([[20.0, 0.0, 0.0, 50.0, 0.0],
                 [0.0, 30.0, 0.0, 50.0, 0.0]], np.float32)
ROW0 = np.array([
    [10.0, 0.0, 0.005],     # in A's window, nearer: a hit
    [30.0, 0.1, 0.005],     # in A's window, beyond A: no hit
    [5.0, 0.02, 0.001],     # in A's window, off the beam: no hit
    [0.0, 10.0, 0.005],     # in B's window, nearer: a hit
    [-10.0, 0.0, 0.005],    # in no window
    [0.5, -0.5, 0.01],      # wide (half-width 0.0141 rad): every point's
])
SETS = [ROW0] + [np.array([[50.0, 50.0, 0.005]])] * 63


def test_frame_work_counts_by_hand():
    work = workcount.frame_work(SCAN, np.arange(64), SETS, CFG)
    # tests: A 3 in window + 1 wide, B 1 + 1 wide
    # bytes: 2 points x 16, 4 held + 1 wide particle x 12, 2 hits x 12,
    # 2 counts x 4
    assert work["occluders"] == (6 * workcount.HIT_TEST_OPS,
                                 2 * 16 + 5 * 12 + 2 * 12 + 2 * 4)
    # each point: one hit; sweep (2 + 2)^2 + 2 * 1 * 3 = 22; one bump and
    # the target, 30 bins each ((10 + 2.998) * 10 -> bins 100..129);
    # two cos/sin pairs
    ops = 2 * (22 + 60 * workcount.WAVE_OPS + 2 * workcount.TRIG_OPS)
    assert work["pulse"] == (ops, 2 * 12 + 2 * 32)


def test_least_seconds_takes_the_larger_bound():
    assert workcount.least_seconds(67e12, 0) == (1.0, "ops")
    assert workcount.least_seconds(0, 3.35e12 * 2) == (2.0, "bytes")


class _Run:
    def __init__(self, trace, frames):
        self.trace, self.frames_traced = trace, frames

    def work(self, frame):
        return {"occluders": (67e12 * 1e-6, 0.0), "pulse": (0.0, 0.0)}


def test_roofline_share_is_mean_least_over_mean_kernel_time():
    # two a1 launches of 4 and 6 us, least time 1 us a frame: 20%
    tr = Trace(["void a1_kernel<32>(float*)", "memset", "a1_kernel"],
               [0.0, 5.0, 10.0], [4.0, 6.0, 16.0], 1.0)
    share = workcount.roofline_share(_Run(tr, [0, 1]), "a1_kernel",
                                     "occluders")
    assert share == pytest.approx(20.0)
    assert workcount.roofline_share(_Run(tr, [0]), "w1_kernel",
                                    "occluders") is None


def test_trace_union_and_gaps():
    tr = Trace(["k1", "k2", "k3"], [0.0, 2.0, 10.0], [5.0, 4.0, 12.0],
               20e-6)
    assert tr.busy_s() == pytest.approx(7e-6)
    assert tr.idle_gaps() == [["k2 -> k3", pytest.approx(5e-6)]]
    assert tr.device_ops()[0] == ["k1", pytest.approx(5e-6)]
