"""Kernels W1 (`ops/occluders.find_occluders_window`) and W2
(`ops/pulse.window_pulse_peaks`), the window assembly's, on the card against
their plain torch versions, exactly, and the window scan on them.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import no
jax, so they also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_window_cuda.py

The scenes are test_torch_cuda.py's small scan with its particle cases:
"scene" (K = 48), "dense" (many large flakes, K = 8: full top-K lists and
occluder overflows), its twin particles (equal ranges in neighbouring
columns, in distant columns, and in a bank column and a wide column), a
window of 1,024 columns (past the bank's 256-column wrap pads, so windows
reach the row's end and repeat its last column) and K = 512 (the largest
list the kernel takes). W2 also runs on crafted points: one at the origin
(a 0/0 target amplitude), equal ratios (ties by slot) with max_bumps 1, a
bump nearer than the receiver ramp (amplitude 0) and three overlapping
bumps.
"""

import math

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu_torch import (
    SnowfallConfig,
    build_bank,
    load_hdl64_calib,
    pad_cloud,
    synthetic_scan,
)
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops import occluders as tocc
from lidar_snow_sim_tpu_torch.ops import pulse as tpulse
from test_torch_cuda import CASES, PLANE, _particle_sets, _twins


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def window_case(case, device, k=None, twins=False, window_size=256,
                max_bumps=None):
    """(cfg, bank tensors, WindowInputs) of the small scan for one case."""
    spec = CASES[case]
    k = k or spec["k"]
    sets = _particle_sets(*spec["sets"])
    bank = build_bank(_twins(sets) if twins else sets, window_size=256,
                      wide_capacity=spec["wide"])
    cfg = SnowfallConfig(max_points=8192, window_size=window_size,
                         wide_capacity=spec["wide"], max_occluders=k,
                         max_bumps=max_bumps or k, point_chunk=2048)
    pc = synthetic_scan(n_azimuth=100, seed=2, calib=load_hdl64_calib())
    pc = pc[np.argsort(pc[:, 4], kind="stable")]
    padded = pad_cloud(pc, cfg.max_points)
    bank_t = ts.bank_to_torch(bank, device)
    plane = (torch.tensor(PLANE[0], dtype=torch.float32, device=device),
             torch.tensor(PLANE[1], dtype=torch.float32, device=device))
    inp = ts.window_inputs(
        torch.as_tensor(padded.points, device=device),
        torch.as_tensor(padded.mask, device=device), bank_t,
        ts.calib_to_torch(load_hdl64_calib(), device),
        torch.as_tensor(np.random.default_rng(3).permutation(64),
                        device=device), None, cfg, plane=plane)
    return cfg, bank_t, inp


def _same(a, b):
    return torch.equal(a, b) or (a.is_floating_point() and torch.equal(
        a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num()))


@pytest.mark.cuda
@pytest.mark.parametrize("case,k,twins,window_size,max_bumps", [
    ("scene", None, False, 256, None),
    ("dense", None, False, 256, None),
    ("dense", None, False, 256, 2),       # bump overflows
    ("scene", None, True, 256, None),
    ("scene", 48, False, 1024, None),
    ("scene", 512, True, 1024, 64),
])
def test_cuda_window_kernels_match_plain(cuda, case, k, twins, window_size,
                                         max_bumps):
    """W1, then W2 on W1's rows, equal their plain versions exactly, each
    launched once."""
    cfg, bank_t, inp = window_case(case, cuda, k, twins, window_size,
                                   max_bumps)
    args, kw = ts.window_occluder_call(inp, bank_t, cfg)
    n0 = tocc.find_occluders_window.launches
    occ = tocc.find_occluders_window(*args, **kw)
    assert tocc.find_occluders_window.launches == n0 + 1
    for got, want in zip(occ, tocc.occluders_window_plain(*args, **kw)):
        assert torch.equal(got, want)
    assert occ[3].any()
    pargs, pkw = ts.window_pulse_call(inp, occ, cfg)
    n0 = tpulse.window_pulse_peaks.launches
    peaks = tpulse.window_pulse_peaks(*pargs, **pkw)
    assert tpulse.window_pulse_peaks.launches == n0 + 1
    for got, want in zip(peaks, tpulse.window_pulse_plain(*pargs, **pkw)):
        assert _same(got, want)
    if case == "dense":
        assert int(occ[4][inp.mask].sum()) > 0
    if max_bumps == 2:
        assert int(peaks[3][inp.mask].sum()) > 0


def crafted_points(device):
    """Four points with hand-made occluder rows (K = 4): at the origin; two
    occluders of equal claimed width; an occluder at 0.5 m (inside the
    receiver ramp, so amplitude 0) before a farther one; three occluders
    at 20, 20.05 and 20.1 m, their pulse windows overlapping."""
    k = 4
    xyz = torch.tensor([[0.0, 0.0, 0.0], [30.0, 0.0, 0.0],
                        [40.0, 0.0, 0.0], [50.0, 0.0, 0.0]])
    cfg = SnowfallConfig()
    right = (-cfg.beam_divergence_rad / 2) % (2 * math.pi)
    left = cfg.beam_divergence_rad / 2
    a1 = torch.zeros((4, k))
    a2 = torch.zeros((4, k))
    dist = torch.full((4, k), float("inf"))
    valid = torch.zeros((4, k), dtype=torch.bool)
    w = cfg.beam_divergence_rad / 4
    rows = {1: [(right, (right + w) % (2 * math.pi), 10.0),
                (left - w, left, 12.0)],
            2: [(right, (right + w) % (2 * math.pi), 0.5),
                (left - w, left, 12.0)],
            3: [(right, left, 20.0), (right, left, 20.05),
                (left - w, left, 20.1)]}
    for p, occs in rows.items():
        for i, (x1, x2, r) in enumerate(occs):
            a1[p, i], a2[p, i], dist[p, i], valid[p, i] = x1, x2, r, True
    return [t.to(device) for t in (xyz, a1, a2, dist, valid)], cfg


@pytest.mark.cuda
@pytest.mark.parametrize("max_bumps", [1, 4])
def test_cuda_w2_crafted_points(cuda, max_bumps):
    (xyz, a1, a2, dist, valid), cfg = crafted_points(cuda)
    args = (xyz, torch.full((4,), 255.0, device=cuda), a1, a2, dist, valid,
            torch.as_tensor(cfg.range_grid(), device=cuda))
    kw = dict(beam_rad=cfg.beam_divergence_rad, ipm=cfg.intervals_per_meter,
              tau_h=cfg.tau_h, max_bumps=max_bumps)
    got = tpulse.window_pulse_peaks(*args, **kw)
    want = tpulse.window_pulse_plain(*args, **kw)
    for g, w in zip(got, want):
        assert _same(g, w)
    assert got[0][0].isnan() and int(got[1][0]) == len(cfg.range_grid())
    assert (int(got[3][1]) > 0) == (max_bumps == 1)


@pytest.mark.cuda
def test_cuda_window_wrappers_check_inputs(cuda):
    """A K the kernel's list does not take, or one past the candidates,
    raises on CUDA tensors; there is no fallback."""
    cfg, bank_t, inp = window_case("scene", cuda)
    args, kw = ts.window_occluder_call(inp, bank_t, cfg)
    with pytest.raises(ValueError, match="max_occluders"):
        tocc.find_occluders_window(*args, **dict(kw, k_occ=513))
    no_wide = (*args[:7], bank_t.wang_t[:, :, :0])   # n_wide 0
    with pytest.raises(ValueError, match="do not fit"):
        tocc.find_occluders_window(*no_wide, **dict(kw, window_size=4,
                                                    k_occ=8))


@pytest.mark.cuda
def test_cuda_window_scan_equals_plain_path(cuda):
    """One window scan launches W1 and W2 once each and equals the chunked
    plain window path on the card byte for byte."""
    cfg, bank_t, _ = window_case("dense", cuda)
    pc = synthetic_scan(n_azimuth=100, seed=2, calib=load_hdl64_calib())
    padded = pad_cloud(pc, cfg.max_points)
    args = (torch.as_tensor(padded.points, device=cuda),
            torch.as_tensor(padded.mask, device=cuda), bank_t,
            ts.calib_to_torch(load_hdl64_calib(), cuda),
            torch.as_tensor(np.random.default_rng(3).permutation(64),
                            device=cuda), None, cfg)
    plane = (torch.tensor(PLANE[0], dtype=torch.float32, device=cuda),
             torch.tensor(PLANE[1], dtype=torch.float32, device=cuda))
    n0 = (tocc.find_occluders_window.launches,
          tpulse.window_pulse_peaks.launches)
    got = ts.snowfall_augment(*args, plane=plane)
    assert (tocc.find_occluders_window.launches,
            tpulse.window_pulse_peaks.launches) == (n0[0] + 1, n0[1] + 1)
    want = ts.window_augment(*args, plane=plane, plain=True)
    for name, a, b in zip(ts.SnowfallResult._fields, got, want):
        assert torch.equal(a, b), name
