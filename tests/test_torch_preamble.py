"""The snowfall preamble on the CPU: the plain versions of kernels P1 and
P2 (`ops/fitting.ransac_plane_plain`, `ops/laser.noise_floor_at_plain`)
and the wrappers that launch the kernels.

`_plane_and_noise` gives, bit for bit, what the composition it ran before
the kernels gave (a frozen copy below) on benchmark scans, in scan order
and channel-sorted, with its own RANSAC and with a given plane. CPU
tensors take the plain versions and count no launch; the kernels'
wrappers raise on a dtype, shape, layout or device that the kernels
cannot take. The card tests are in test_torch_preamble_cuda.py.
"""

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu_torch import SnowfallConfig, pad_cloud
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops import fitting, laser
from lidar_snow_sim_tpu_torch.ops.f32 import div
from lidar_snow_sim_tpu_torch.ops.geometry import norm3
from port_bench.inputs import load_calib, synthetic_scan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_scan(seed: int, channel_sorted: bool, n: int = 65536):
    """(points (n, 5), mask (n,)) of a benchmark scan padded to n rows."""
    pc = synthetic_scan(load_calib(), seed=seed)
    if channel_sorted:
        pc = pc[np.argsort(pc[:, 4], kind="stable")]
    padded = pad_cloud(pc, n)
    return torch.as_tensor(padded.points), torch.as_tensor(padded.mask)


# ---- the composition before kernels P1 and P2, frozen ----

def _ransac_before(xyz, mask, draws, standard_height=-1.55):
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    crop = (mask & (z < -1.55) & (z > -1.86 - 0.01 * x) & (x > 10)
            & (x < 70) & (y > -3) & (y < 3))
    n_crop = crop.sum()
    _, thresh = fitting.masked_median_and_mad(z, crop)
    c = torch.cumsum(crop.to(torch.float32), 0)
    u = torch.minimum(draws * c[-1], c[-1] - 0.5)
    idx = torch.searchsorted(c, u.contiguous(), right=True).clamp(
        0, c.shape[0] - 1)
    pts = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    coef, det = fitting._solve3(pts[idx] + 1e-12 * eye, z[idx])
    resid = z[None, :] - (x[None, :] * coef[:, 0:1]
                          + y[None, :] * coef[:, 1:2] + coef[:, 2:3])
    ok = torch.isfinite(coef).all(dim=1) & (det.abs() > 1e-6)
    inliers = crop[None, :] & (resid ** 2 < thresh) & ok[:, None]
    inl = fitting._at(inliers, torch.argmax(inliers.sum(dim=1)))
    w_ = inl.to(torch.float32)
    n_in = w_.sum().clamp_min(1.0)
    mx = (w_ * x).sum() / n_in
    my = (w_ * y).sum() / n_in
    mz = (w_ * z).sum() / n_in
    cx, cy, cz = x - mx, y - my, z - mz
    sxx = (w_ * cx * cx).sum()
    sxy = (w_ * cx * cy).sum()
    syy = (w_ * cy * cy).sum()
    sxz = (w_ * cx * cz).sum()
    syz = (w_ * cy * cz).sum()
    g = torch.stack([torch.stack([sxx, sxy]), torch.stack([sxy, syy])])
    eye2 = torch.eye(2, dtype=xyz.dtype, device=xyz.device)
    ab = fitting._solve2(g + 1e-9 * eye2, torch.stack([sxz, syz]))
    intercept = mz - ab[0] * mx - ab[1] * my
    w_vec = torch.stack([ab[0], ab[1], -torch.ones_like(ab[0])])
    w_vec = w_vec / torch.linalg.vector_norm(w_vec)
    good = ((n_crop > 3) & (inl.sum() >= 3) & torch.isfinite(w_vec).all()
            & torch.isfinite(intercept))
    flat = torch.tensor([0.0, 0.0, 1.0], dtype=xyz.dtype, device=xyz.device)
    return (torch.where(good, w_vec, flat),
            torch.where(good, intercept, standard_height))


def _rows_before(distance, norm_int, mask):
    n_points = mask.sum()
    y_hi = torch.where(mask, norm_int, -float("inf")).max().abs()
    xi, x_ok = laser._bin_index(distance, 10.0, 70.0, 50)
    yi, y_ok = laser._bin_index(norm_int, 5.0, y_hi, 2555)
    ok = mask & x_ok & y_ok
    sentinel = 50 * 2555
    s = torch.sort(torch.where(ok, xi * 2555 + yi, sentinel)).values
    n = s.shape[0]
    iota = torch.arange(n)
    is_start = torch.ones(n, dtype=torch.bool)
    is_start[1:] = s[1:] != s[:-1]
    start_pos = torch.where(is_start, iota, n)
    suf_min = torch.flip(torch.cummin(torch.flip(start_pos, [0]), 0).values,
                         [0])
    nxt = torch.cat([suf_min[1:], torch.full((1,), n)])
    cnt = nxt - iota
    valid = is_start & (s < sentinel)
    row_of, ybin_of = s // 2555, s % 2555
    in_row = (row_of[None, :] == torch.arange(50)[:, None]) & valid[None, :]
    cnt_b = cnt[None, :].expand(in_row.shape)
    big = 2**31 - 1
    cmin = torch.where(in_row, cnt_b, big).min(dim=1).values
    ymin_at_cmin = torch.where(in_row & (cnt_b == cmin[:, None]),
                               ybin_of[None, :], big).min(dim=1).values
    ymins = torch.where((cmin == big) | (cmin >= n_points), 0, ymin_at_cmin)
    yedge = 5.0 + div(ymins.to(torch.float32) * (y_hi - 5.0), 2555)
    xedges = torch.linspace(10.0, 70.0, 51)
    return (xedges[:-1] + xedges[1:]) * 0.5, yedge, yedge > 5.0


def _plane_and_noise_before(xyz, intensity, mask, dist, draws, cfg, plane):
    w, h = _ransac_before(xyz, mask, draws) if plane is None else plane
    hog = xyz @ w + h
    ground = mask & (hog < cfg.ground_delta) & (hog > -cfg.ground_delta)
    incident = torch.arccos(torch.clamp(
        (xyz @ w) / (dist.clamp_min(1e-12) * torch.linalg.vector_norm(w)),
        -1, 1))
    norm_int = intensity / torch.cos(incident)
    distance = norm3(xyz)
    slope, icpt = fitting.masked_linregress(distance, norm_int, ground)
    p_power = torch.stack([torch.zeros_like(slope), slope, icpt])
    x, min_vals, row_ok = _rows_before(distance, norm_int, ground)
    s, i = fitting.masked_linregress(x, min_vals, row_ok)
    p_rows = torch.stack([torch.zeros_like(s), s, i])
    p_min = torch.where(row_ok.sum() > 3, p_rows, p_power)
    threshold = cfg.noise_floor * fitting.polyval2(p_min, distance)
    threshold = threshold * torch.cos(incident)
    noise_poly = fitting.masked_polyfit2(dist, threshold, ground)
    return fitting.polyval2(noise_poly, dist)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("channel_sorted", [False, True])
def test_plane_and_noise_equal_the_composition_before(seed, channel_sorted):
    pts, mask = bench_scan(seed, channel_sorted)
    xyz, intensity, dist = pts[:, :3], pts[:, 3], norm3(pts[:, :3])
    cfg = SnowfallConfig()
    draws = fitting.ransac_draws(seed, cfg.ransac_trials)
    w, h = fitting.ransac_plane(xyz, mask, draws)
    w0, h0 = _ransac_before(xyz, mask, draws)
    assert torch.equal(w, w0) and torch.equal(h, h0)
    assert float(w[2]) != 1.0   # a fitted plane, not the flat earth
    got = ts._plane_and_noise(xyz, intensity, mask, dist, draws, cfg, None)
    want = _plane_and_noise_before(xyz, intensity, mask, dist, draws, cfg,
                                   None)
    assert torch.equal(got, want)
    plane = (torch.tensor([0.01, -0.02, 0.9997], dtype=torch.float32),
             torch.tensor(1.74, dtype=torch.float32))
    got = laser.noise_floor_at(xyz, intensity, mask, dist, plane, cfg)
    want = _plane_and_noise_before(xyz, intensity, mask, dist, None, cfg,
                                   plane)
    assert torch.equal(got, want)


def test_cpu_tensors_take_the_plain_versions():
    pts, mask = bench_scan(3, True, n=53248)
    xyz, intensity, dist = pts[:, :3], pts[:, 3], norm3(pts[:, :3])
    cfg = SnowfallConfig()
    draws = fitting.ransac_draws(3, cfg.ransac_trials)
    n1, n2 = fitting.ransac_plane.launches, laser.noise_floor_at.launches
    w, h = fitting.ransac_plane(xyz, mask, draws)
    wp, hp = fitting.ransac_plane_plain(xyz, mask, draws)
    assert torch.equal(w, wp) and torch.equal(h, hp)
    got = laser.noise_floor_at(xyz, intensity, mask, dist, (w, h), cfg)
    assert torch.equal(got, laser.noise_floor_at_plain(
        xyz, intensity, mask, dist, (w, h), cfg))
    assert (fitting.ransac_plane.launches, laser.noise_floor_at.launches) \
        == (n1, n2)


def test_ransac_trials_are_order_statistics():
    """The plain steps kernel P1 is held to exactly: the crop's median and
    MAD of z are order statistics of a sort (numpy's, in float32), and each
    trial's inliers lie in the crop."""
    pts, mask = bench_scan(1, False)
    xyz = pts[:, :3]
    crop, med, mad, inliers = fitting.ransac_trials_plain(
        xyz, mask, fitting.ransac_draws(1, 64))
    s = np.sort(xyz[:, 2][crop].numpy())
    lo, hi = (len(s) - 1) // 2, len(s) // 2
    m = np.float32((s[lo] + s[hi]) * np.float32(0.5))
    d = np.sort(np.abs(s - m))
    assert float(med) == m
    assert float(mad) == np.float32((d[lo] + d[hi]) * np.float32(0.5))
    assert inliers.shape == (64, xyz.shape[0])
    assert not (inliers & ~crop).any() and int(inliers.sum(1).max()) > 0


# case: (inputs to replace, the message the wrapper raises); a CPU tensor
# of a layout the kernel takes (the points' planes, as wet ground passes
# them) gets as far as the device check
BAD_P1 = {
    "xyz_dtype": (dict(xyz=lambda p: p[:, :3].double()), "dtype"),
    "xyz_shape": (dict(xyz=lambda p: p[:, :4]), "shape"),
    "xyz_planes": (dict(xyz=lambda p: p.t().contiguous()[:3].t()), "CUDA"),
    "mask_dtype": (dict(mask=lambda m: m.to(torch.uint8)), "dtype"),
    "mask_layout": (dict(mask=lambda m: torch.stack([m, m], 1)[:, 0]),
                    "contiguous"),
    "draws_dtype": (dict(draws=lambda d: d.double()), "dtype"),
    "draws_shape": (dict(draws=lambda d: d[:, :2].contiguous()), "shape"),
    "draws_layout": (dict(draws=lambda d: d.t().contiguous().t()),
                     "contiguous"),
    "cpu": ({}, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(BAD_P1))
def test_p1_wrapper_raises(case):
    pts, mask = bench_scan(0, True, n=53248)
    args = dict(xyz=pts[:, :3], mask=mask,
                draws=fitting.ransac_draws(0, 64))
    bad, message = BAD_P1[case]
    for name, make in bad.items():
        args[name] = make(pts if name == "xyz" else args[name])
    with pytest.raises(ValueError, match=message):
        fitting.ransac_plane_p1(args["xyz"], args["mask"], args["draws"])


BAD_P2 = {
    "xyz_planes": (dict(xyz=lambda a: a["xyz"].t().contiguous().t()),
                   "CUDA"),
    "intensity_dtype": (dict(intensity=lambda a: a["intensity"].half()),
                        "dtype"),
    "intensity_shape": (dict(intensity=lambda a: a["intensity"][:-1]),
                        "shape"),
    "mask_dtype": (dict(mask=lambda a: a["mask"].float()), "dtype"),
    "dist_layout": (dict(dist=lambda a: a["xyz"][:, 0]), "contiguous"),
    "w_dtype": (dict(w=lambda a: a["w"].double()), "dtype"),
    "w_shape": (dict(w=lambda a: a["w"][:2]), "shape"),
    "h_shape": (dict(h=lambda a: torch.zeros(2)), "shape"),
    "cpu": ({}, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(BAD_P2))
def test_p2_wrapper_raises(case):
    pts, mask = bench_scan(0, True, n=53248)
    args = dict(xyz=pts[:, :3], intensity=pts[:, 3], mask=mask,
                dist=norm3(pts[:, :3]), w=torch.tensor([0.0, 0.0, 1.0]),
                h=torch.tensor(1.75))
    bad, message = BAD_P2[case]
    for name, make in bad.items():
        args[name] = make(args)
    with pytest.raises(ValueError, match=message):
        laser.noise_floor_p2(args["xyz"], args["intensity"], args["mask"],
                             args["dist"], (args["w"], args["h"]),
                             SnowfallConfig())
