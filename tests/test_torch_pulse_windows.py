"""The windowed waveform rule of kernel C1 (`ops/pulse.pulse_windows`)
against the plain version's full waveform, on the CPU.

C1 evaluates the waveform only on the union of the target's window and
the windows of the occluder bumps before the last active one with a
nonzero amplitude, and takes +0.0 at the lowest bin outside that union.
`windowed_peak` states that rule in plain torch; each case here holds its
(peak, first bin) equal to `pulse_plain`'s, which sums every bump over all
M bins. The crafted beams (test_torch_cuda.CRAFTED, which also runs them
through kernels C1 and C2 on the card) reach the rule's edges; the last
cases are the phase-C inputs of the card tests' scenes.
"""

import pytest
import torch

from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops.occluders import occluders_plain
from lidar_snow_sim_tpu_torch.ops.pulse import (
    bump_amplitudes,
    pulse_plain,
    pulse_windows,
    windowed_peak,
)
from test_torch_cuda import CASES, CRAFTED, crafted, crafted_case, kw, layout


def scene_case(case):
    """Phase C's inputs on one of the card tests' scenes (plain phase A,
    phase B on the CPU)."""
    lay, calib, cfg = layout(case)
    a12d, ovf = occluders_plain(*lay.occluder_args, **lay.occluder_kw)
    comp = ts.compact_occluded(lay, a12d, ovf, ts.calib_to_torch(calib, "cpu"),
                               cfg)
    return comp.pulse_args, comp.pulse_kw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_rule_holds(args, pkw):
    peak, first, _, _ = pulse_plain(*args, **pkw)
    w_peak, w_first = windowed_peak(*args, **pkw)
    assert torch.equal(w_first, first)
    assert torch.equal(w_peak, peak)     # -0.0 == +0.0
    return peak, first


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_windowed_rule_matches_plain_crafted(name):
    args, pkw = crafted_case(name)
    peak, first = assert_rule_holds(args, pkw)
    rr_all, amp, last, _, _ = bump_amplitudes(
        *args[:5], beam_rad=pkw["beam_rad"], xsi_r1=pkw["xsi_r1"],
        xsi_r2=pkw["xsi_r2"])
    lo, hi = pulse_windows(rr_all, amp, last, ipm=pkw["ipm"],
                           c_tau=pkw["c_tau"], m_bins=args[7].shape[0])
    m_last = args[7].shape[0] - 1
    # what makes each case the case its name says
    if name == "overlapping windows":
        assert lo[1, 0] <= hi[0, 0] and int(last.max()) == 2
    elif name == "window reaching bin 0":
        assert lo[0, 0] == 0 and amp[0, 0] > 0
    elif name == "window past the last bin":
        assert hi[-1, 0] == m_last and (args[0][0, 0] + pkw["c_tau"]) \
            * pkw["ipm"] > m_last
    elif name == "zero amplitude before the last active bump":
        assert amp[0, 0] == 0 and int(last.max()) == 2 and lo[0, 0] > hi[0, 0]
    elif name == "pulse below zero at the edge":
        assert (lo[-1, 0], hi[-1, 0]) == (5, 5)
        assert (float(peak[0]), int(first[0])) == (0.0, 0)
    elif name == "pulse below zero at bin 0":
        assert (lo[-1, 0], hi[-1, 0]) == (0, 0)
        assert (float(peak[0]), int(first[0])) == (0.0, 1)
    elif name == "all amplitudes zero":
        assert (float(peak[0]), int(first[0])) == (0.0, 0)


def test_windowed_rule_takes_any_window_order():
    """The rule itself does not need the windows by range: bumps out of
    range order (phase A's top-K never gives them, and kernel C1 requires
    ascending ranges) still give the plain version's peak."""
    args, pkw = crafted(60.0, [(1.0, 1.001, 30.0), (1.001, 1.002, 12.0)]), kw()
    assert_rule_holds(args, pkw)
    rr_all, amp, last, _, _ = bump_amplitudes(
        *args[:5], beam_rad=pkw["beam_rad"], xsi_r1=pkw["xsi_r1"],
        xsi_r2=pkw["xsi_r2"])
    lo, hi = pulse_windows(rr_all, amp, last, ipm=pkw["ipm"],
                           c_tau=pkw["c_tau"], m_bins=args[7].shape[0])
    assert lo[0, 0] > lo[1, 0] and lo[1, 0] <= hi[1, 0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_windowed_rule_matches_plain_on_scenes(case):
    """The bench-like draws: every compacted beam of the scene."""
    args, pkw = scene_case(case)
    assert_rule_holds(args, pkw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pulse_windows_are_the_predicate(case):
    """pulse_windows' integer bounds hold exactly the bins m with
    r * ipm <= m <= (r + c_tau) * ipm, for every walked bump."""
    args, pkw = scene_case(case)
    m_bins = args[7].shape[0]
    rr_all, amp, last, _, _ = bump_amplitudes(
        *args[:5], beam_rad=pkw["beam_rad"], xsi_r1=pkw["xsi_r1"],
        xsi_r2=pkw["xsi_r2"])
    lo, hi = pulse_windows(rr_all, amp, last, ipm=pkw["ipm"],
                           c_tau=pkw["c_tau"], m_bins=m_bins)
    walked = lo <= hi
    assert bool(walked[-1].any())
    binf = torch.arange(m_bins, dtype=torch.float32)[:, None, None]
    in_window = (binf >= rr_all * pkw["ipm"]) & (
        binf <= (rr_all + pkw["c_tau"]) * pkw["ipm"])
    bins = torch.arange(m_bins)[:, None, None]
    in_bounds = (bins >= lo) & (bins <= hi)
    assert torch.equal(in_bounds, in_window & walked)
    # the bumps come in ascending order of range, the target the farthest,
    # so C1's walk takes each window less the one before it
    assert bool((rr_all[:-1].diff(dim=0) >= 0).all())
    occupied = walked[:-1].any(dim=0)
    assert bool((rr_all[:-1].amin(dim=0) < rr_all[-1])[occupied].all())
