"""Kernels A1 (also folded over frames), A2, A3, A4a, A4b, C1, C2 and L1
on the card against their plain torch versions (C1 and C2 also on the
crafted beams of test_torch_pulse_windows.py, C2 also on pairs whose two
beams diverge).

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import no
jax, so they also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports jax for the JAX package's tests).
The scenes here also feed test_torch_kernels.py.
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
from lidar_snow_sim_tpu_torch.config import SPEED_OF_LIGHT
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops.lut_lookup import (
    MAX_CELLS,
    lut_lookup_pairs,
    lut_lookup_plain,
)
from lidar_snow_sim_tpu_torch.ops.occluders import (
    find_occluders,
    find_occluders_banded,
    find_occluders_folded,
    find_occluders_pair,
    find_occluders_routed,
    find_occluders_t,
    occluders_banded_plain,
    occluders_plain,
    occluders_routed_plain,
    occluders_ungated_plain,
)
from lidar_snow_sim_tpu_torch.ops.pulse import (
    pulse_peaks,
    pulse_peaks_pair,
    pulse_plain,
)

_W = np.array([0.005, -0.003, -1.0])
PLANE = (_W / np.linalg.norm(_W), -1.55)


def _particle_sets(seed, n, spread, r_max, d_min=0.0):
    rng = np.random.default_rng(seed)
    sets = []
    for _ in range(64):
        ang = rng.uniform(-spread, spread, n)
        d = np.sqrt(rng.uniform(0.01, 1, n)) * 60 + d_min
        r = rng.uniform(0.005, r_max, n)
        sets.append(np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))
    return sets


# "scene": the test_dense_assembly bank; "dense": many large flakes in the
# scan's FOV with K = 8, so beams overflow and the top-K list is full
CASES = {
    "scene": dict(sets=(5, 300, np.pi, 0.05), wide=64, k=48),
    "dense": dict(sets=(9, 3000, 0.9, 0.15, 2.0), wide=512, k=8),
}


def _twins(sets, n_wide=40):
    """Each set three times: as drawn, again (equal ranges in neighbouring
    bank columns) and mirrored in y (equal ranges in distant columns); then
    its `n_wide` nearest narrow particles once more with a radius past the
    bank's wide threshold (equal ranges in a bank column and a wide
    column)."""
    out = []
    for s in sets:
        d = np.hypot(s[:, 0], s[:, 1])
        narrow = np.arcsin(np.clip(s[:, 2] / d, 0.0, 1.0)) <= 5e-3
        near = np.argsort(np.where(narrow, d, np.inf))[:n_wide]
        wide = s[near].copy()
        wide[:, 2] = d[near] * 0.01
        out.append(np.concatenate([s, s, s * np.array([1.0, -1.0, 1.0]),
                                   wide]))
    return out


def layout(case, device="cpu", slice_width=256, order=None, sets=None,
           k=None, twins=False, **cfg_kw):
    """The port's phase-A layout of the small scene for one case; `cfg_kw`
    (route_band, band_width, band_group, pallas_transposed, pallas_pair)
    selects kernel A2, A3, A4a or A4b; `order` is the channel order,
    `sets` replaces the case's particle-set arguments, `k` its K, and
    `twins` repeats every particle (see _twins)."""
    spec = CASES[case]
    k = k or spec["k"]
    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=100, seed=2, calib=calib)
    particles = _particle_sets(*(sets or spec["sets"]))
    bank = build_bank(_twins(particles) if twins else particles,
                      window_size=256,
                      wide_capacity=spec["wide"])
    cfg = SnowfallConfig(
        max_points=8192, window_size=256, wide_capacity=spec["wide"],
        max_occluders=k, max_bumps=k, assembly="dense",
        channel_capacity=128, block_points=32, slice_width=slice_width,
        **cfg_kw,
    )
    padded = pad_cloud(pc, cfg.max_points)
    plane = (torch.tensor(PLANE[0], dtype=torch.float32, device=device),
             torch.tensor(PLANE[1], dtype=torch.float32, device=device))
    lay = ts.dense_layout(
        torch.as_tensor(padded.points, device=device),
        torch.as_tensor(padded.mask, device=device),
        ts.bank_to_torch(bank, device),
        torch.as_tensor(np.random.default_rng(3).permutation(64)
                        if order is None else order, device=device),
        None, cfg, plane=plane,
    )
    return lay, calib, cfg


# Phase-C beams crafted to reach the edges of C1's windowed waveform
# (ops/pulse.pulse_windows); test_torch_pulse_windows.py holds the rule
# against the plain version on them.
CFG = SnowfallConfig()
C_TAU = SPEED_OF_LIGHT * CFG.tau_h
# a unit vector whose dot product with itself rounds above 1 in float32:
# 0.5 * (1 - dot) is -6e-8, a pulse a hair below zero
C_ROUND, S_ROUND = 0.14303084, 0.98971826


def crafted(d_orig, occluders, *, k=4, amp_scale=100.0, edge_bin=None):
    """Phase-C inputs of one beam, [right, left] = [1.0, 1.002], with valid
    occluders `occluders` = [(a1, a2, range), ...] (slots 0, 1, ...) and the
    bench's range grid. `edge_bin`: the grid's cos/sin there and the
    target's are C_ROUND/S_ROUND, so the target's pulse rounds below zero
    at that bin."""
    grid = torch.as_tensor(CFG.range_grid())
    phase = 2.0 * math.pi / C_TAU
    feats = torch.tensor([[d_orig], [1.0], [1.002], [amp_scale]],
                         dtype=torch.float32)
    a1 = torch.zeros((k, 1))
    a2 = torch.zeros((k, 1))
    rr = torch.full((k, 1), 3.0e38)
    valid = torch.zeros((k, 1))
    for i, (x1, x2, r) in enumerate(occluders):
        a1[i], a2[i], rr[i], valid[i] = x1, x2, r, 1.0
    all_r = torch.cat([rr, feats[:1]])
    cos_b, sin_b = torch.cos(phase * all_r), torch.sin(phase * all_r)
    cos_g, sin_g = torch.cos(phase * grid), torch.sin(phase * grid)
    if edge_bin is not None:
        cos_g[edge_bin], sin_g[edge_bin] = C_ROUND, S_ROUND
        cos_b[k], sin_b[k] = C_ROUND, S_ROUND
    return (feats, a1, a2, rr, valid, cos_b, sin_b, cos_g, sin_g)


def kw(c_tau=C_TAU, xsi_r1=CFG.xsi_r1, xsi_r2=CFG.xsi_r2):
    return dict(beam_rad=CFG.beam_divergence_rad,
                ipm=float(CFG.intervals_per_meter), c_tau=c_tau,
                xsi_r1=xsi_r1, xsi_r2=xsi_r2)


# xsi_r1 = -1, xsi_r2 = 0: the receiver ramp is 1 from range 0 on, so a
# bump near the sensor keeps its amplitude; c_tau 0.05: a one-bin window
NEAR = dict(xsi_r1=-1.0, xsi_r2=0.0)
CRAFTED = {
    "overlapping windows": (
        (40.0, [(1.0, 1.0008, 10.0), (1.0008, 1.0015, 10.5)]), {}, {}),
    "window reaching bin 0": ((30.0, [(1.0, 1.001, 0.0)]), {}, NEAR),
    "window past the last bin": ((122.5, [(1.0, 1.001, 50.0)]), {}, {}),
    # occluder 0 is a point at 1.0005: no sweep midpoint falls in it, so it
    # claims nothing and has amplitude 0 before the last active bump
    "zero amplitude before the last active bump": (
        (60.0, [(1.0005, 1.0005, 20.0), (1.001, 1.002, 25.0)]), {}, {}),
    "pulse below zero at the edge": (
        (0.5, []), dict(edge_bin=5), dict(c_tau=0.05)),
    "pulse below zero at bin 0": (
        (0.0, []), dict(edge_bin=0), dict(c_tau=0.05, **NEAR)),
    "all amplitudes zero": (
        (40.0, [(1.0, 1.001, 10.0)]), dict(amp_scale=0.0), {}),
}


def crafted_case(name):
    (d_orig, occ), beam_kw, pulse_kw = CRAFTED[name]
    return crafted(d_orig, occ, **beam_kw), kw(**pulse_kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case,slice_width", [
    ("dense", 256), ("scene", 256),
    # wider than the bank row (812 columns): the slice is clipped to the
    # row and, with the wide list, spans two shared-memory tiles
    ("scene", 2048),
])
def test_cuda_kernels_match_plain(cuda, case, slice_width):
    """On the card: A1 and C1 equal their plain versions exactly."""
    lay, calib, cfg = layout(case, device=cuda, slice_width=slice_width)
    n0 = find_occluders.launches
    a12d, ovf = find_occluders(*lay.occluder_args, **lay.occluder_kw)
    assert find_occluders.launches == n0 + 1
    a12d_p, ovf_p = occluders_plain(*lay.occluder_args, **lay.occluder_kw)
    k = cfg.max_occluders
    assert torch.equal(ovf, ovf_p)
    assert torch.equal(a12d[2 * k:], a12d_p[2 * k:])
    live = torch.cat([a12d_p[2 * k:] < 1e37] * 2)
    assert torch.equal(a12d[:2 * k][live], a12d_p[:2 * k][live])
    comp = ts.compact_occluded(lay, a12d, ovf, ts.calib_to_torch(calib, cuda),
                               cfg)
    for got, want in zip(pulse_peaks(*comp.pulse_args, **comp.pulse_kw),
                         pulse_plain(*comp.pulse_args, **comp.pulse_kw)):
        assert torch.equal(got, want)


def _assert_phase_a_equal(a12d, ovf, a12d_p, ovf_p, k):
    assert torch.equal(ovf, ovf_p)
    assert torch.equal(a12d[2 * k:], a12d_p[2 * k:])
    live = torch.cat([a12d_p[2 * k:] < 1e37] * 2)
    assert torch.equal(a12d[:2 * k][live], a12d_p[:2 * k][live])


@pytest.mark.cuda
@pytest.mark.parametrize("case,slice_width,sets,k,twins", [
    # K = 24, 64 and 512 on the scene; its ~20% dead chunks write sentinels
    ("scene", 256, None, 24, False), ("scene", 256, None, 64, False),
    ("scene", 256, None, 512, False),
    # every particle three times: equal ranges in neighbouring columns (other
    # lanes of a beam) and in distant ones, ties to the lowest column
    ("scene", 512, None, 24, True),
    # K = 8 under many large flakes: beams with more hits than K
    ("dense", 256, None, 8, False),
    # 12,000 flakes a channel, the whole row as the slice: lists longer than
    # one 2,048-column staged tile and than a CTA's 227 KB of shared memory
    ("dense", 16384, (9, 12000, 0.9, 0.1, 2.0), 8, False),
])
def test_cuda_a1_matches_plain(cuda, case, slice_width, sets, k, twins):
    """On the card: the redesigned A1 (a beam's list split over four
    lanes, merged in lax.top_k order) equals its plain version exactly."""
    lay, _, cfg = layout(case, device=cuda, slice_width=slice_width,
                         sets=sets, k=k, twins=twins)
    has = lay.occluder_args[4]
    n0 = find_occluders.launches
    a12d, ovf = find_occluders(*lay.occluder_args, **lay.occluder_kw)
    torch.cuda.synchronize()
    assert find_occluders.launches == n0 + 1
    a12d_p, ovf_p = occluders_plain(*lay.occluder_args, **lay.occluder_kw)
    _assert_phase_a_equal(a12d, ovf, a12d_p, ovf_p, k)
    if case == "scene" and not twins:
        assert bool((has == 0).any())                  # dead chunks
        dead = (has == 0).repeat_interleave(lay.blk)
        assert bool((a12d[2 * k:, dead] == 3.0e38).all())
        assert not bool(ovf.reshape(-1)[dead].any())
    if case == "dense":
        assert bool((ovf > 0).any())                   # more hits than K
    if twins:                                          # ties were kept
        d = a12d[2 * k:]
        assert bool(((d[1:] == d[:-1]) & (d[1:] < 1e37)).any())
    if sets is not None:                               # 24 bytes a column
        assert int(lay.occluder_args[5].max()) > 232448 // 24


@pytest.mark.cuda
def test_cuda_wrapper_checks_inputs(cuda):
    """A wrapper raises on what its kernel does not take, before launching."""
    lay, _, _ = layout("scene", device=cuda)
    args = list(lay.occluder_args)
    n0 = find_occluders.launches
    args[2] = args[2].long()                          # rows as int64
    with pytest.raises(ValueError, match="rows"):
        find_occluders(*args, **lay.occluder_kw)
    with pytest.raises(ValueError, match="max_occluders"):
        find_occluders(*lay.occluder_args,
                       **dict(lay.occluder_kw, k_occ=1024))
    assert find_occluders.launches == n0
    lay2, _, _ = layout("scene", device=cuda, route_band=128, band_group=8)
    n2 = find_occluders_routed.launches
    with pytest.raises(ValueError, match="band_group"):
        find_occluders_routed(*lay2.occluder_args,
                              **dict(lay2.occluder_kw, group=5))
    args = list(lay2.occluder_args)
    args[4] = args[4][:-1]                            # gloa one short
    with pytest.raises(ValueError, match="gloa"):
        find_occluders_routed(*args, **lay2.occluder_kw)
    assert find_occluders_routed.launches == n2


# (case, route_band or band_width, band_group, slice_width, sets, k,
# twins) of the routed (A2) and banded (A3) card tests
LONG = (9, 12000, 0.9, 0.1, 2.0)   # 12,000 flakes a channel
ROUTED_CASES = [
    ("dense", 128, 8, 256, None, None, False),
    ("dense", 96, 8, 256, None, None, False),
    ("scene", 128, 8, 256, None, None, False),
    ("scene", 96, 8, 256, None, None, False),
    # A1's hard cases: K = 24, 64 and 512; every particle three times and
    # some once more as wide flakes (ties to the lowest column, across
    # lanes, runs and bank / wide); K = 8 under many large flakes (the dense
    # cases above); bands of 4,096 columns and full slices of 8,320, longer
    # than one 2,048-column staged pass
    ("scene", 128, 8, 256, None, 24, False),
    ("scene", 128, 8, 256, None, 64, False),
    ("scene", 128, 8, 256, None, 512, False),
    ("scene", 128, 8, 512, None, 24, True),
    ("dense", 4096, 8, 8192, LONG, 8, False),
    # groups of 2 and 4 beams: one warp's beams span groups with their own
    # bands
    ("scene", 128, 2, 256, None, None, False),
    ("scene", 128, 4, 512, None, 24, True),
]
BANDED_CASES = [
    ("dense", 256, 8, 384, None, None, False),
    ("scene", 256, 8, 384, None, None, False),
    ("scene", 256, 8, 384, None, 24, False),
    ("scene", 256, 8, 384, None, 64, False),
    ("scene", 256, 8, 384, None, 512, False),
    ("scene", 256, 8, 384, None, 24, True),
    # 128-column bands of 16-beam groups: a tie across bands A and B
    ("scene", 128, 16, 384, None, 24, True),
    ("dense", 2560, 8, 8192, LONG, 8, False),
    ("scene", 256, 2, 384, None, None, False),
    ("dense", 256, 4, 384, None, None, False),
]


def _grouped_layout(kernel, case, width, group, slice_width, sets, k,
                    twins, device):
    knob = "route_band" if kernel == "A2" else "band_width"
    lay, _, cfg = layout(case, device=device, slice_width=slice_width,
                         sets=sets, k=k, twins=twins, band_group=group,
                         **{knob: width})
    assert lay.kernel == kernel
    return lay, cfg


def _assert_grouped_case(a12d, ovf, case, k, twins):
    if case == "dense":
        assert bool((ovf > 0).any())                   # more hits than K
    if twins:                                          # ties were kept
        d = a12d[2 * k:]
        assert bool(((d[1:] == d[:-1]) & (d[1:] < 1e37)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case,route,group,slice_width,sets,k,twins",
                         ROUTED_CASES)
def test_cuda_routed_matches_plain(cuda, case, route, group, slice_width,
                                   sets, k, twins):
    """On the card: A2 equals its plain version exactly, and A1 on the
    in-channel beams (dist plane and overflow)."""
    lay, cfg = _grouped_layout("A2", case, route, group, slice_width, sets,
                               k, twins, cuda)
    n0 = find_occluders_routed.launches
    a12d, ovf = find_occluders_routed(*lay.occluder_args, **lay.occluder_kw)
    torch.cuda.synchronize()
    assert find_occluders_routed.launches == n0 + 1
    a12d_p, ovf_p = occluders_routed_plain(*lay.occluder_args,
                                           **lay.occluder_kw)
    k = cfg.max_occluders
    assert torch.equal(ovf, ovf_p)
    assert torch.equal(a12d, a12d_p)
    _assert_grouped_case(a12d, ovf, case, k, twins)
    lay1, _, _ = layout(case, device=cuda, slice_width=slice_width,
                        sets=sets, k=k, twins=twins)
    a12d_1, ovf_1 = find_occluders(*lay1.occluder_args, **lay1.occluder_kw)
    valid = lay.valid_blk.reshape(-1)
    assert torch.equal(ovf.reshape(-1)[valid], ovf_1.reshape(-1)[valid])
    assert torch.equal(a12d[2 * k:, valid], a12d_1[2 * k:, valid])


@pytest.mark.cuda
@pytest.mark.parametrize("case,band,group,slice_width,sets,k,twins",
                         BANDED_CASES)
def test_cuda_banded_matches_plain(cuda, case, band, group, slice_width,
                                   sets, k, twins):
    """On the card: A3 equals its plain version exactly, coverage plane
    included."""
    lay, cfg = _grouped_layout("A3", case, band, group, slice_width, sets,
                               k, twins, cuda)
    n0 = find_occluders_banded.launches
    got = find_occluders_banded(*lay.occluder_args, **lay.occluder_kw)
    torch.cuda.synchronize()
    assert find_occluders_banded.launches == n0 + 1
    want = occluders_banded_plain(*lay.occluder_args, **lay.occluder_kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _assert_grouped_case(got[0], got[1], case, cfg.max_occluders, twins)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cells", [((65536, 64), 127), ((8193,), 127),
                                         ((3, 5), 127),
                                         ((8193,), MAX_CELLS)])
def test_cuda_l1_matches_plain(cuda, shape, cells):
    """On the card: L1 equals its plain version exactly on LISA's bench
    shape and on ragged ones, at knots and at p == g1, through both the
    float4 path and the scalar path (an offset view of the positions), on
    LISA's 127-cell table and on the widest one the kernel stages."""
    rng = np.random.default_rng(0)
    qb = rng.uniform(0.2, 36.7, cells + 1).astype(np.float32)
    pairs = torch.as_tensor(np.stack([qb[:-1], qb[1:]], axis=1), device=cuda)
    g1 = cells
    p = rng.uniform(0, g1, shape).astype(np.float32)
    flat = p.reshape(-1)
    flat[: min(g1 + 1, flat.size)] = np.arange(min(g1 + 1, flat.size))
    flat[-1] = g1
    p = torch.as_tensor(p, device=cuda)
    n0 = lut_lookup_pairs.launches
    got = lut_lookup_pairs(p, pairs)
    torch.cuda.synchronize()
    assert lut_lookup_pairs.launches == n0 + 1
    assert got.shape == p.shape and torch.equal(got, lut_lookup_plain(p, pairs))
    tail = p.reshape(-1)[1:]
    assert torch.equal(lut_lookup_pairs(tail, pairs),
                       lut_lookup_plain(tail, pairs))
    assert float(got.reshape(-1)[-1]) == float(qb[-1])


@pytest.mark.cuda
def test_cuda_l1_rejects_wide_tables(cuda):
    """A table over MAX_CELLS cells raises before any launch."""
    n0 = lut_lookup_pairs.launches
    with pytest.raises(ValueError, match="cells"):
        lut_lookup_pairs(torch.zeros(8, device=cuda),
                         torch.zeros((MAX_CELLS + 1, 2), device=cuda))
    assert lut_lookup_pairs.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A4a", "A4b"])
@pytest.mark.parametrize("case,slice_width,sets,k,twins", [
    ("dense", 256, None, None, False), ("scene", 256, None, None, False),
    ("scene", 2048, None, None, False),
    # 6000 flakes a channel and the whole row as the slice: candidate lists
    # longer than one staged tile
    ("dense", 8192, (9, 6000, 0.9, 0.15, 2.0), None, False),
    # A1's cases (test_cuda_a1_matches_plain): K = 24, 64 and 512; every
    # particle three times (ties to the lowest column, across lanes and
    # lists); K = 8 under many large flakes; 12,000 flakes a channel, lists
    # longer than a tile and than a CTA's 227 KB of shared memory
    ("scene", 256, None, 24, False), ("scene", 256, None, 64, False),
    ("scene", 256, None, 512, False), ("scene", 512, None, 24, True),
    ("dense", 256, None, 8, False),
    ("dense", 16384, (9, 12000, 0.9, 0.1, 2.0), 8, False),
])
def test_cuda_ungated_kernels_match_plain(cuda, kernel, case, slice_width,
                                          sets, k, twins):
    """On the card: A4a and A4b equal their plain version (A1's with every
    chunk live) exactly, dead chunks included, where they hold computed
    hits and not A1's sentinels, and A1 on the in-channel beams."""
    knob = "pallas_transposed" if kernel == "A4a" else "pallas_pair"
    lay, _, cfg = layout(case, device=cuda, slice_width=slice_width,
                         sets=sets, k=k, twins=twins, **{knob: True})
    assert lay.kernel == kernel
    run = find_occluders_t if kernel == "A4a" else find_occluders_pair
    n0 = run.launches
    a12d, ovf = run(*lay.occluder_args, **lay.occluder_kw)
    torch.cuda.synchronize()
    assert run.launches == n0 + 1
    a12d_p, ovf_p = occluders_ungated_plain(*lay.occluder_args,
                                            **lay.occluder_kw)
    k = cfg.max_occluders
    _assert_phase_a_equal(a12d, ovf, a12d_p, ovf_p, k)
    dead = (~lay.valid_blk.any(dim=1)).repeat_interleave(lay.blk)
    assert bool(dead.any())
    assert bool((a12d[2 * k:, dead] < 1e37).any())     # computed, not empty
    assert torch.equal(a12d[2 * k:, dead], a12d_p[2 * k:, dead])
    assert torch.equal(ovf.reshape(-1)[dead], ovf_p.reshape(-1)[dead])
    if case == "dense":
        assert bool((ovf > 0).any())                   # more hits than K
    if twins:                                          # ties were kept
        d = a12d[2 * k:]
        assert bool(((d[1:] == d[:-1]) & (d[1:] < 1e37)).any())
    if sets is not None and sets[1] > 6000:            # 24 bytes a column
        assert int(lay.occluder_args[4].max()) > 232448 // 24
    lay1, _, _ = layout(case, device=cuda, slice_width=slice_width,
                        sets=sets, k=k, twins=twins)
    a12d_1, ovf_1 = find_occluders(*lay1.occluder_args, **lay1.occluder_kw)
    valid = lay.valid_blk.reshape(-1)
    assert torch.equal(ovf.reshape(-1)[valid], ovf_1.reshape(-1)[valid])
    assert torch.equal(a12d[2 * k:, valid], a12d_1[2 * k:, valid])


@pytest.mark.cuda
def test_cuda_folded_a1_matches_single_launches(cuda):
    """On the card: A1 folded over 2 frames (one launch) equals one A1
    launch per frame."""
    order = np.random.default_rng(3).permutation(64)
    lays = [layout("scene", device=cuda)[0],
            layout("scene", device=cuda, order=order[::-1].copy())[0]]
    n0 = find_occluders.launches
    got = find_occluders_folded([lay.occluder_args for lay in lays],
                                **lays[0].occluder_kw)
    torch.cuda.synchronize()
    assert find_occluders.launches == n0 + 1
    for (a12d, ovf), lay in zip(got, lays):
        want = find_occluders(*lay.occluder_args, **lay.occluder_kw)
        assert torch.equal(a12d, want[0]) and torch.equal(ovf, want[1])


def _compacted(case, cuda, k=None):
    """Phase C's inputs of a card-test scene: A1, then the compaction."""
    lay, calib, cfg = layout(case, device=cuda, k=k)
    a12d, ovf = find_occluders(*lay.occluder_args, **lay.occluder_kw)
    return ts.compact_occluded(lay, a12d, ovf,
                               ts.calib_to_torch(calib, cuda), cfg)


def _assert_c2_equals_plain_and_c1(args, kw, blk):
    n0 = pulse_peaks_pair.launches
    got = pulse_peaks_pair(*args, blk=blk, **kw)
    torch.cuda.synchronize()
    assert pulse_peaks_pair.launches == n0 + 1
    for a, b, c in zip(got, pulse_plain(*args, **kw),
                       pulse_peaks(*args, **kw)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
# every scene at its own K, and the scene at K = 64 and K = 512 (C2's
# large shared-memory launch)
@pytest.mark.parametrize("case,k", [("dense", None), ("scene", None),
                                    ("scene", 64), ("scene", 512)])
@pytest.mark.parametrize("blk", [1, 64, 512])
def test_cuda_c2_matches_plain(cuda, case, k, blk):
    """On the card: C2 equals its plain version (C1's) and C1 exactly."""
    comp = _compacted(case, cuda, k)
    assert (comp.cap // blk) % 2 == 0
    _assert_c2_equals_plain_and_c1(comp.pulse_args, comp.pulse_kw, blk)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("padded", ["odd", "even"])
@pytest.mark.parametrize("blk", [1, 64])
def test_cuda_c2_unequal_pairs(cuda, case, padded, blk):
    """On the card: C2 equals its plain version and C1 where a pair's two
    beams diverge: every odd (or even) pulse block made all padding slots
    (no valid occluder), so each warp runs a full beam beside an empty
    one, and the compacted order's own occluded/padding boundary."""
    comp = _compacted(case, cuda)
    args = list(comp.pulse_args)
    blocks = torch.arange(comp.cap, device=cuda) // blk
    args[4] = args[4].masked_fill(blocks % 2 == (padded == "odd"), 0.0)
    assert bool((args[4] > 0.5).any())
    _assert_c2_equals_plain_and_c1(args, comp.pulse_kw, blk)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["C1", "C2"])
def test_cuda_phase_c_one_launch_bool_touched(cuda, kernel):
    """On the card: C1 and C2 write touched as torch.bool themselves, so
    a call launches its kernel and nothing else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    comp = _compacted("scene", cuda)
    args, kw = comp.pulse_args, comp.pulse_kw
    if kernel == "C1":
        def run():
            return pulse_peaks(*args, **kw)
    else:
        def run():
            return pulse_peaks_pair(*args, blk=64, **kw)
    out = run()
    torch.cuda.synchronize()
    assert out[2].dtype == torch.bool
    assert torch.equal(out[2], pulse_plain(*args, **kw)[2])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    assert names and all(f"{kernel.lower()}_kernel" in n for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 512])
@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_cuda_pulse_windows_crafted(cuda, name, k):
    """On the card: C1 (the windowed waveform) and C2 equal their plain
    version on the crafted beams, one beam (C1 alone in its CTA) and the
    beam twice (C2 with blk 1); K = 512 takes C1's and C2's large
    shared-memory launches."""
    (d_orig, occ), beam_kw, pulse_kw = CRAFTED[name]
    args = [t.to(cuda) for t in crafted(d_orig, occ, k=k, **beam_kw)]
    pkw = kw(**pulse_kw)
    for cap in (1, 2):
        a = [t if i >= 7 else t.repeat(1, cap) for i, t in enumerate(args)]
        want = pulse_plain(*a, **pkw)
        runs = [pulse_peaks(*a, **pkw)]
        if cap == 2:
            runs.append(pulse_peaks_pair(*a, blk=1, **pkw))
        torch.cuda.synchronize()
        for got in runs:
            for g, w in zip(got, want):
                assert torch.equal(g, w)
