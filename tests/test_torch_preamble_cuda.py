"""Kernels P1 (`ops/fitting.ransac_plane_p1`) and P2
(`ops/laser.noise_floor_p2`), the snowfall preamble's, on the card against
their plain torch versions on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import no
jax, so they also run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_preamble_cuda.py

Scans: the benchmark's synthetic scans (port_bench.inputs), padded to
65,536 rows, in scan order and channel-sorted, read as row views of the
points and as views of their planes (wet ground's layout). P1 equals the plain version
exactly in the crop's size, its median and MAD of z, every trial's inlier
count and the chosen trial; its (w, h) within W_ATOL (its sums run in
another order). Given the plain version's plane, P2 equals it exactly in
the ground band, y_hi, each row's bin of fewest points, each row's edge and
the usable rows; its fits and noise floor within NOISE_RTOL. Crafted crops
of 0 to 5 points, tied z values, a crop of every point; a ground band in
two distance rows (the power fit's fallback) and none at all. Two runs give
the same bits; a window scan and a dense frame launch each kernel once.
"""

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu_torch import (
    SnowfallConfig,
    build_bank,
    load_hdl64_calib,
    pad_cloud,
)
from lidar_snow_sim_tpu_torch import synthetic_scan as small_scan
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops import fitting, laser
from lidar_snow_sim_tpu_torch.ops.geometry import norm3
from port_bench.inputs import load_calib, synthetic_scan
from test_torch_cuda import CASES, _particle_sets

# P1's refit sums ~4,000 inliers in another order than torch: a few float32
# roundings of the means and centred sums, ~1e-7 on the unit normal and
# the intercept (1.75 m: ulp 1.2e-7)
W_ATOL = 1e-6
# P2's fits sum ~10,000 ground points in another order and solve the 3x3
# normal equations by another LU; relative to max(|floor|, 1)
NOISE_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def bench_scan(seed, channel_sorted, dev, n=65536):
    pc = synthetic_scan(load_calib(), seed=seed)
    if channel_sorted:
        pc = pc[np.argsort(pc[:, 4], kind="stable")]
    padded = pad_cloud(pc, n)
    return (torch.as_tensor(padded.points, device=dev),
            torch.as_tensor(padded.mask, device=dev))


def crafted(n_crop, dev, n=4096, ties=False, seed=0):
    """(xyz (n, 3), mask) with `n_crop` points in RANSAC's road crop, at
    random rows, on a plane tilted by a few mrad (with `ties`: at three
    heights); the rest above it."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = rng.uniform(12, 68, n)
    xyz[:, 1] = rng.uniform(-2.9, 2.9, n)
    xyz[:, 2] = rng.uniform(0.5, 2.0, n)
    rows = rng.choice(n, n_crop, replace=False)
    if ties:   # three heights: ties in z and in |z - median|
        z = rng.choice([-1.70, -1.75, -1.80], n_crop)
    else:
        z = (-1.75 + 0.003 * xyz[rows, 0] - 0.002 * xyz[rows, 1]
             + rng.normal(0, 0.02, n_crop))
    xyz[rows, 2] = np.clip(z, -1.97, -1.56)
    return (torch.as_tensor(xyz, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev))


def hold_p1(xyz, mask, draws):
    """P1 against the plain version: exact where it counts and selects,
    W_ATOL on the plane."""
    out, info = fitting.ransac_plane_p1(xyz, mask, draws)
    crop, med, mad, inliers = fitting.ransac_trials_plain(xyz, mask, draws)
    counts = inliers.sum(dim=1)
    assert int(info[0]) == int(crop.sum())
    assert torch.equal(out[4], med), (float(out[4]), float(med))
    assert torch.equal(out[5], mad), (float(out[5]), float(mad))
    assert torch.equal(info[2:].long(), counts), (info[2:], counts)
    assert int(info[1]) == int(torch.argmax(counts))
    w, h = fitting.ransac_plane_plain(xyz, mask, draws)
    if float(w[2]) == 1.0:   # the flat earth, exactly
        assert torch.equal(out[:3], w) and torch.equal(out[3], h)
    else:
        assert (out[:3] - w).abs().max() <= W_ATOL, (out[:4], w, h)
        assert (out[3] - h).abs() <= W_ATOL, (out[:4], w, h)
    return out, info


def hold_p2(xyz, intensity, mask, dist, plane, cfg, rtol=NOISE_RTOL):
    """P2 against the plain version on the same plane: exact in the ground
    band and the histogram, `rtol` on the floor."""
    noise, stats, ground = laser.noise_floor_p2(xyz, intensity, mask, dist,
                                                plane, cfg)
    g, incident = laser.ground_and_incidence(xyz, mask, dist, plane,
                                             cfg.ground_delta)
    norm_int = intensity / torch.cos(incident)
    distance = norm3(xyz)
    assert torch.equal(ground != 0, g), int(((ground != 0) != g).sum())
    assert int(stats[0]) == int(g.sum())
    bins, y_hi = laser.noise_floor_bins(distance, norm_int, g)
    assert torch.equal(stats[1], y_hi), (float(stats[1]), float(y_hi))
    assert torch.equal(stats[10:60].long(), bins), (stats[10:60], bins)
    _, yedge, row_ok = laser.noise_floor_rows(distance, norm_int, g)
    assert torch.equal(stats[60:110].nan_to_num(), yedge.nan_to_num())
    assert int(stats[6]) == int(row_ok.sum())
    want = laser.noise_floor_at_plain(xyz, intensity, mask, dist, plane, cfg)
    err = ((noise - want).abs() / want.abs().clamp_min(1.0)).max()
    assert float(err) <= rtol, float(err)
    return noise, stats


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4100000007])
@pytest.mark.parametrize("channel_sorted", [False, True])
def test_preamble_on_bench_scans(cuda, seed, channel_sorted):
    pts, mask = bench_scan(seed, channel_sorted, cuda)
    xyz, intensity, dist = pts[:, :3], pts[:, 3], norm3(pts[:, :3])
    draws = fitting.ransac_draws(seed, 64).to(cuda)
    out, info = hold_p1(xyz, mask, draws)
    assert 3000 < int(info[0]) < 6000 and float(out[2]) != 1.0
    plane = fitting.ransac_plane_plain(xyz, mask, draws)
    _, stats = hold_p2(xyz, intensity, mask, dist, plane, SnowfallConfig())
    assert int(stats[6]) > 3   # the row fit, not its fallback


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 4100000007])
def test_preamble_on_the_points_planes(cuda, seed):
    """xyz and intensity as views of the points' (5, N) planes, as wet
    ground passes them: the bits the row views give."""
    pts, mask = bench_scan(seed, False, cuda)
    planes = pts.t().contiguous()
    xyz, intensity, dist = planes[:3].t(), planes[3], norm3(pts[:, :3])
    draws = fitting.ransac_draws(seed, 64).to(cuda)
    out, info = hold_p1(xyz, mask, draws)
    rows = fitting.ransac_plane_p1(pts[:, :3], mask, draws)
    assert torch.equal(out, rows[0]) and torch.equal(info, rows[1])
    plane = fitting.ransac_plane_plain(xyz, mask, draws)
    cfg = SnowfallConfig()
    noise, _ = hold_p2(xyz, intensity, mask, dist, plane, cfg)
    assert torch.equal(noise, laser.noise_floor_p2(
        pts[:, :3], pts[:, 3], mask, dist, plane, cfg)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_crop", [0, 1, 2, 3, 4, 5, 64, 65])
@pytest.mark.parametrize("ties", [False, True])
def test_p1_on_crafted_crops(cuda, n_crop, ties):
    xyz, mask = crafted(n_crop, cuda, ties=ties, seed=n_crop)
    out, info = hold_p1(xyz, mask, fitting.ransac_draws(n_crop, 64).to(cuda))
    assert int(info[0]) == n_crop
    if n_crop <= 3:
        assert out[:4].tolist() == [0.0, 0.0, 1.0, np.float32(-1.55)]


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_p1_crop_of_every_point(cuda, ties):
    xyz, mask = crafted(65536, cuda, n=65536, ties=ties)
    _, info = hold_p1(xyz, mask, fitting.ransac_draws(7, 64).to(cuda))
    assert int(info[0]) == 65536


@pytest.mark.cuda
def test_p1_odd_trials_and_masked_rows(cuda):
    xyz, mask = crafted(301, cuda, n=9999, seed=5)
    mask[::3] = False
    hold_p1(xyz, mask, fitting.ransac_draws(5, 37).to(cuda))


@pytest.mark.cuda
def test_p2_power_fit_fallback_and_no_ground(cuda):
    """A ground band in two distance rows (<= 3 usable rows: the power
    fit), then none at all (no row, y_hi inf)."""
    pts, mask = bench_scan(2, True, cuda)
    xyz, intensity = pts[:, :3], pts[:, 3]
    dist = norm3(xyz)
    plane = fitting.ransac_plane_plain(xyz, mask, fitting.ransac_draws(
        2, 64).to(cuda))
    cfg = SnowfallConfig()
    narrow = mask & (dist > 20.0) & (dist < 22.0)
    # the power fit over 20-22 m has slope -3,739 and intercept 78,672, so
    # the floor is a difference of two ~78,000 terms (ulp 0.008): the plain
    # version's own floor moves 3.8e-4 when its points are reordered (its
    # sums then run in another order); P2 read 8.2e-4 on the card
    _, stats = hold_p2(xyz, intensity, narrow, dist, plane, cfg, rtol=2e-3)
    assert int(stats[6]) <= 3 and int(stats[0]) > 100
    far = (plane[0], plane[1] + 100.0)
    _, stats = hold_p2(xyz, intensity, mask, dist, far, cfg)
    assert int(stats[0]) == 0


@pytest.mark.cuda
def test_two_runs_give_the_same_bits(cuda):
    pts, mask = bench_scan(1, False, cuda)
    xyz, intensity, dist = pts[:, :3], pts[:, 3], norm3(pts[:, :3])
    draws = fitting.ransac_draws(1, 64).to(cuda)
    cfg = SnowfallConfig()
    runs = []
    for _ in range(2):
        out, info = fitting.ransac_plane_p1(xyz, mask, draws)
        noise, stats, ground = laser.noise_floor_p2(
            xyz, intensity, mask, dist, (out[:3], out[3]), cfg)
        runs.append((out, info, noise, stats.nan_to_num(), ground))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("assembly", ["window", "dense"])
def test_a_scan_launches_each_kernel_once(cuda, assembly):
    spec = CASES["scene"]
    bank = build_bank(_particle_sets(*spec["sets"]), window_size=256,
                      wide_capacity=spec["wide"])
    extra = {} if assembly == "window" else dict(
        assembly="dense", channel_capacity=256, block_points=32)
    cfg = SnowfallConfig(max_points=8192, window_size=256,
                         wide_capacity=spec["wide"], max_occluders=spec["k"],
                         max_bumps=spec["k"], point_chunk=2048, **extra)
    pc = small_scan(n_azimuth=100, seed=2, calib=load_hdl64_calib())
    padded = pad_cloud(pc, cfg.max_points)
    args = (torch.as_tensor(padded.points, device=cuda),
            torch.as_tensor(padded.mask, device=cuda),
            ts.bank_to_torch(bank, cuda),
            ts.calib_to_torch(load_hdl64_calib(), cuda),
            torch.as_tensor(np.random.default_rng(3).permutation(64),
                            device=cuda),
            fitting.ransac_draws(0, cfg.ransac_trials).to(cuda), cfg)
    before = fitting.ransac_plane.launches, laser.noise_floor_at.launches
    ts.snowfall_augment(*args)
    torch.cuda.synchronize()
    after = fitting.ransac_plane.launches, laser.noise_floor_at.launches
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
