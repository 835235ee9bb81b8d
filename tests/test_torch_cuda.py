"""Kernels A1 (also folded over frames), A2, A3, A4a, A4b, C1, C2 and L1
on the card against their plain torch versions.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import no
jax, so they also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports jax for the JAX package's tests).
The scenes here also feed test_torch_kernels.py.
"""

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


def layout(case, device="cpu", slice_width=256, order=None, sets=None,
           **cfg_kw):
    """The port's phase-A layout of the small scene for one case; `cfg_kw`
    (route_band, band_width, band_group, pallas_transposed, pallas_pair)
    selects kernel A2, A3, A4a or A4b; `order` is the channel order and
    `sets` replaces the case's particle-set arguments."""
    spec = CASES[case]
    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=100, seed=2, calib=calib)
    bank = build_bank(_particle_sets(*(sets or spec["sets"])),
                      window_size=256,
                      wide_capacity=spec["wide"])
    cfg = SnowfallConfig(
        max_points=8192, window_size=256, wide_capacity=spec["wide"],
        max_occluders=spec["k"], max_bumps=spec["k"], assembly="dense",
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


@pytest.mark.cuda
@pytest.mark.parametrize("route", [128, 96])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_routed_matches_plain(cuda, case, route):
    """On the card: A2 equals its plain version exactly, and A1 on the
    in-channel beams (dist plane and overflow)."""
    lay, _, cfg = layout(case, device=cuda, route_band=route, band_group=8)
    assert lay.kernel == "A2"
    n0 = find_occluders_routed.launches
    a12d, ovf = find_occluders_routed(*lay.occluder_args, **lay.occluder_kw)
    assert find_occluders_routed.launches == n0 + 1
    a12d_p, ovf_p = occluders_routed_plain(*lay.occluder_args,
                                           **lay.occluder_kw)
    k = cfg.max_occluders
    assert torch.equal(ovf, ovf_p)
    assert torch.equal(a12d, a12d_p)
    lay1, _, _ = layout(case, device=cuda)
    a12d_1, ovf_1 = find_occluders(*lay1.occluder_args, **lay1.occluder_kw)
    valid = lay.valid_blk.reshape(-1)
    assert torch.equal(ovf.reshape(-1)[valid], ovf_1.reshape(-1)[valid])
    assert torch.equal(a12d[2 * k:, valid], a12d_1[2 * k:, valid])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_banded_matches_plain(cuda, case):
    """On the card: A3 equals its plain version exactly, coverage plane
    included."""
    lay, _, _ = layout(case, device=cuda, slice_width=384, band_width=256,
                       band_group=8)
    assert lay.kernel == "A3"
    n0 = find_occluders_banded.launches
    got = find_occluders_banded(*lay.occluder_args, **lay.occluder_kw)
    assert find_occluders_banded.launches == n0 + 1
    want = occluders_banded_plain(*lay.occluder_args, **lay.occluder_kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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


def _assert_phase_a_equal(a12d, ovf, a12d_p, ovf_p, k):
    assert torch.equal(ovf, ovf_p)
    assert torch.equal(a12d[2 * k:], a12d_p[2 * k:])
    live = torch.cat([a12d_p[2 * k:] < 1e37] * 2)
    assert torch.equal(a12d[:2 * k][live], a12d_p[:2 * k][live])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A4a", "A4b"])
@pytest.mark.parametrize("case,slice_width,sets", [
    ("dense", 256, None), ("scene", 256, None), ("scene", 2048, None),
    # 6000 flakes a channel and the whole row as the slice: candidate lists
    # longer than A4a's 4096-candidate tile, staged once per beam round
    ("dense", 8192, (9, 6000, 0.9, 0.15, 2.0)),
])
def test_cuda_ungated_kernels_match_plain(cuda, kernel, case, slice_width,
                                          sets):
    """On the card: A4a and A4b equal their plain version (A1's with every
    chunk live) exactly, dead chunks included, and A1 on the in-channel
    beams."""
    knob = "pallas_transposed" if kernel == "A4a" else "pallas_pair"
    lay, _, cfg = layout(case, device=cuda, slice_width=slice_width,
                         sets=sets, **{knob: True})
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
    lay1, _, _ = layout(case, device=cuda, slice_width=slice_width,
                        sets=sets)
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("blk", [64, 512])
def test_cuda_c2_matches_plain(cuda, case, blk):
    """On the card: C2 equals its plain version (C1's) and C1 exactly."""
    lay, calib, cfg = layout(case, device=cuda)
    a12d, ovf = find_occluders(*lay.occluder_args, **lay.occluder_kw)
    comp = ts.compact_occluded(lay, a12d, ovf, ts.calib_to_torch(calib, cuda),
                               cfg)
    assert (comp.cap // blk) % 2 == 0
    n0 = pulse_peaks_pair.launches
    got = pulse_peaks_pair(*comp.pulse_args, blk=blk, **comp.pulse_kw)
    torch.cuda.synchronize()
    assert pulse_peaks_pair.launches == n0 + 1
    for a, b, c in zip(got, pulse_plain(*comp.pulse_args, **comp.pulse_kw),
                       pulse_peaks(*comp.pulse_args, **comp.pulse_kw)):
        assert torch.equal(a, b) and torch.equal(a, c)
