"""Masked regression and RANSAC on tensors (counterpart of
`lidar_snow_sim_tpu/ops/fitting.py`).

Fixed-shape, mask-driven estimators: linregress, a centered degree-2
polyfit, masked medians, and the RANSAC ground-plane fit with the
reference's crop and flat-earth fallback. RANSAC takes its random draws as
an argument (`draws`, the (trials, 3) uniforms in [0, 1)), so a caller can
hand both packages the same numbers. On CUDA tensors RANSAC runs as kernel
P1 (`csrc/preamble.cu`, one launch, no host sync), on CPU tensors as
`ransac_plane_plain`.
"""

from __future__ import annotations

import math

import torch

from lidar_snow_sim_tpu_torch import _kernels

_BIG = 3.0e38


def _at(a, i):
    """a[i] for an index tensor i of any shape, without a host round trip
    (indexing with a 0-dim tensor reads it on the host, which synchronizes
    a GPU)."""
    return a.index_select(0, i.reshape(-1)).reshape(i.shape + a.shape[1:])


def masked_mean(x, mask):
    n = mask.sum().clamp_min(1)
    return torch.where(mask, x, 0.0).sum() / n


def masked_linregress(x, y, mask):
    """Least-squares slope and intercept over masked samples."""
    xm = masked_mean(x, mask)
    ym = masked_mean(y, mask)
    dx = torch.where(mask, x - xm, 0.0)
    dy = torch.where(mask, y - ym, 0.0)
    denom = (dx * dx).sum()
    slope = (dx * dy).sum() / denom.clamp_min(1e-30)
    return slope, ym - slope * xm


def masked_polyfit2(x, y, mask):
    """Degree-2 least-squares fit; returns (p2, p1, p0), highest power first.

    Solved in the centered/scaled basis u = (x - mu) / sigma so the 3x3
    normal equations stay well-conditioned in float32 at 80 m ranges.
    """
    mu = masked_mean(x, mask)
    var = masked_mean((x - mu) ** 2, mask)
    sigma = torch.sqrt(var.clamp_min(1e-12))
    u = torch.where(mask, (x - mu) / sigma, 0.0)
    w = mask.to(x.dtype)

    cols = torch.stack([u * u, u, w], dim=-1)          # (N, 3)
    g = cols.T @ cols
    b = cols.T @ torch.where(mask, y, 0.0)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    a, bu, cu = torch.linalg.solve(g + 1e-9 * eye, b)

    p2 = a / (sigma * sigma)
    p1 = bu / sigma - 2 * a * mu / (sigma * sigma)
    p0 = a * mu * mu / (sigma * sigma) - bu * mu / sigma + cu
    return torch.stack([p2, p1, p0])


def polyval2(p, x):
    return p[0] * x * x + p[1] * x + p[2]


def masked_median(x, mask):
    """Median over masked values (mean of the two middle order statistics
    for even counts, as numpy)."""
    n = mask.sum()
    s = torch.sort(torch.where(mask, x, _BIG)).values
    lo = ((n - 1) // 2).clamp_min(0)
    hi = (n // 2).clamp_min(0)
    return (_at(s, lo) + _at(s, hi)) * 0.5


def _merged_kth(s, p, n, m1, k):
    """k-th smallest (0-based) of {|s[i] - m1| : i < n} for ascending s,
    without a second sort; k may be a tensor of several ranks, searched
    together.

    |s - m1| over a sorted s is two sorted runs, A[t] = m1 - s[p-1-t] and
    B[u] = s[p+u] - m1, so the k-th order statistic is a two-sorted-array
    selection: a binary search on how many of the k+1 smallest come from
    A. The value returned is the same f32 subtraction a sort of
    |x - m1| would see, so it equals `masked_median(|x - m1|, mask)`'s
    order statistic exactly.
    """
    inf = float("inf")
    last = s.shape[0] - 1
    nb = n - p

    def a_val(t):
        v = (_at(s, (p - 1 - t).clamp(0, last)) - m1).abs()
        return torch.where(t < 0, -inf, torch.where(t >= p, inf, v))

    def b_val(u):
        v = (_at(s, (p + u).clamp(0, last)) - m1).abs()
        return torch.where(u < 0, -inf, torch.where(u >= nb, inf, v))

    lo = (k + 1 - nb).clamp_min(0)
    hi = torch.minimum(k + 1, p)
    ans = torch.zeros(k.shape, dtype=s.dtype, device=s.device)
    done = torch.zeros(k.shape, dtype=torch.bool, device=s.device)
    steps = int(math.ceil(math.log2(max(int(s.shape[0]), 2)))) + 2
    for _ in range(steps):
        a = (lo + hi) // 2
        a_last, b_last = a_val(a - 1), b_val(k - a)
        a_next, b_next = a_val(a), b_val(k + 1 - a)
        too_many_a = a_last > b_next
        too_few_a = b_last > a_next
        val = torch.maximum(a_last, b_last)
        ok = ~too_many_a & ~too_few_a
        lo = torch.where(~done & too_few_a, a + 1, lo)
        hi = torch.where(~done & too_many_a, a - 1, hi)
        ans = torch.where(~done & ok, val, ans)
        done = done | ok
    return ans


def masked_median_and_mad(x, mask):
    """(median, median of |x - median|) over masked values from one sort;
    equal to `m = masked_median(x, mask); masked_median(|x - m|, mask)`."""
    n = mask.sum()
    s = torch.sort(torch.where(mask, x, _BIG)).values
    lo = ((n - 1) // 2).clamp_min(0)
    hi = (n // 2).clamp_min(0)
    m1 = (_at(s, lo) + _at(s, hi)) * 0.5
    # entries strictly below m1 among the n valid ones
    p = torch.minimum(torch.searchsorted(s, m1.reshape(1))[0], n)
    v_lo, v_hi = _merged_kth(s, p, n, m1, torch.stack([lo, hi]))
    mad = (v_lo + v_hi) * 0.5
    # n == 0: the caller discards the fit, only finiteness matters
    return m1, torch.where(n > 0, mad, _BIG)


def _solve3(a, b):
    """Closed-form 3x3 solve by the adjugate over leading batch dims.

    Returns (solution (..., 3), det (...)); the caller rejects
    near-singular samples by |det|, since the adjugate turns a degenerate
    sample into large but finite values."""
    def e(i, j):
        return a[..., i, j]

    c00 = e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1)
    c01 = e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2)
    c02 = e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)
    det = e(0, 0) * c00 + e(0, 1) * c01 + e(0, 2) * c02
    c10 = e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2)
    c11 = e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0)
    c12 = e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1)
    c20 = e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1)
    c21 = e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2)
    c22 = e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    sol = torch.stack([
        c00 * b0 + c10 * b1 + c20 * b2,
        c01 * b0 + c11 * b1 + c21 * b2,
        c02 * b0 + c12 * b1 + c22 * b2,
    ], dim=-1)
    return sol / det[..., None], det


def _solve2(a, b):
    """Closed-form 2x2 solve."""
    det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    return torch.stack([
        a[1, 1] * b[0] - a[0, 1] * b[1], a[0, 0] * b[1] - a[1, 0] * b[0]
    ]) / det


def ransac_draws(seed: int, trials: int, generator=None) -> torch.Tensor:
    """(trials, 3) RANSAC uniforms in [0, 1) on the CPU, from `generator`
    or else a fresh one seeded `seed`."""
    if generator is None:
        generator = torch.Generator().manual_seed(int(seed))
    return torch.rand((trials, 3), generator=generator)


MAX_TRIALS = 1024  # kernel P1: a trial a thread of its one CTA


def ransac_plane(xyz, mask, draws, standard_height: float = -1.55):
    """RANSAC ground-plane fit with the reference's crop and fallback
    (oracle/fitting.ransac_plane; tools/wet_ground/planes.py:12-50).

    `draws` holds the (trials, 3) uniforms in [0, 1) that pick each
    trial's three crop points. Returns (w, h): unit normal (3,) and raw
    intercept; the flat-earth plane ([0, 0, 1], -1.55) when the crop has
    <= 3 points or the refit degenerates. CUDA tensors take kernel P1
    (`ransac_plane_p1`), CPU tensors `ransac_plane_plain`.
    """
    if xyz.device.type == "cpu":
        return ransac_plane_plain(xyz, mask, draws, standard_height)
    out, _ = ransac_plane_p1(xyz, mask.contiguous(), draws.contiguous(),
                             standard_height)
    return out[:3], out[3]


ransac_plane.launches = 0


def ransac_plane_p1(xyz, mask, draws, standard_height: float = -1.55):
    """Kernel P1 (`csrc/preamble.cu`) on CUDA tensors: xyz (N, 3) f32 at
    any strides (a column view of the points, or of their planes), mask (N,)
    bool, draws (trials, 3) f32, 1 <= trials <= MAX_TRIALS. Returns
    (out (6,) f32: w (3,), h, the crop's median and MAD of z; info
    (2 + trials,) int32: the crop's size, the chosen trial, each trial's
    inlier count), on the device; the host reads nothing."""
    n = xyz.shape[0]
    trials = draws.shape[0] if draws.dim() == 2 else 0
    if n < 1 or not 1 <= trials <= MAX_TRIALS:
        raise ValueError(f"ransac_plane: {n} points and {trials} trials; "
                         f"kernel P1 takes >= 1 and 1 to {MAX_TRIALS}")
    rs, cs = _kernels.check_layout("xyz", xyz, torch.float32, (n, 3),
                                   strided=True)
    _kernels.check_layout("mask", mask, torch.bool, (n,))
    _kernels.check_layout("draws", draws, torch.float32, (trials, 3))
    dev = _kernels.check_cuda(xyz=xyz, mask=mask, draws=draws)
    scratch = torch.empty(3 * n, dtype=torch.float32, device=dev)
    out = torch.empty(6, dtype=torch.float32, device=dev)
    info = torch.empty(2 + trials, dtype=torch.int32, device=dev)
    err = _kernels.launch(
        dev, _kernels.load("preamble").preamble_p1,
        xyz.data_ptr(), rs, cs, mask.data_ptr(), draws.data_ptr(), trials,
        n, standard_height, scratch.data_ptr(), out.data_ptr(),
        info.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _kernels.check(err, "kernel P1 (preamble_p1)")
    ransac_plane.launches += 1
    return out, info


def ransac_trials_plain(xyz, mask, draws):
    """The plain version's road crop (N,) bool, the crop's median and MAD
    of z, and each trial's inliers (trials, N) bool: `ransac_plane`'s
    steps before the refit, which kernel P1 matches exactly."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    crop = (
        mask
        & (z < -1.55)
        & (z > -1.86 - 0.01 * x)
        & (x > 10)
        & (x < 70)
        & (y > -3)
        & (y < 3)
    )
    med, thresh = masked_median_and_mad(z, crop)

    # inverse-CDF sampling over crop points; clamping u to c[-1] - 0.5
    # keeps searchsorted(side="right") inside the last crop point when
    # u * c[-1] rounds up to c[-1]
    c = torch.cumsum(crop.to(torch.float32), 0)
    u = torch.minimum(draws * c[-1], c[-1] - 0.5)
    idx = torch.searchsorted(c, u.contiguous(), right=True).clamp(
        0, c.shape[0] - 1
    )                                                         # (T, 3)

    pts = torch.stack([x, y, torch.ones_like(x)], dim=-1)     # (N, 3)
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    coef, det = _solve3(pts[idx] + 1e-12 * eye, z[idx])       # (T, 3), (T,)
    resid = z[None, :] - (
        x[None, :] * coef[:, 0:1] + y[None, :] * coef[:, 1:2] + coef[:, 2:3]
    )
    # |det| gate: a genuine crop triangle has |det| >> 1e-6; collinear or
    # repeated samples land near 0 and are rejected explicitly
    ok = torch.isfinite(coef).all(dim=1) & (det.abs() > 1e-6)
    inliers = crop[None, :] & (resid ** 2 < thresh) & ok[:, None]
    return crop, med, thresh, inliers


def ransac_plane_plain(xyz, mask, draws, standard_height: float = -1.55):
    """Plain torch version of kernel P1: `ransac_plane` on any device."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    crop, _, _, inliers = ransac_trials_plain(xyz, mask, draws)
    n_crop = crop.sum()
    inl = _at(inliers, torch.argmax(inliers.sum(dim=1)))

    # weighted least-squares refit on the best trial's inliers (centered)
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
    ab = _solve2(g + 1e-9 * eye2, torch.stack([sxz, syz]))
    intercept = mz - ab[0] * mx - ab[1] * my

    w_vec = torch.stack([ab[0], ab[1], -torch.ones_like(ab[0])])
    w_vec = w_vec / torch.linalg.vector_norm(w_vec)

    good = (
        (n_crop > 3)
        & (inl.sum() >= 3)
        & torch.isfinite(w_vec).all()
        & torch.isfinite(intercept)
    )
    flat = torch.tensor([0.0, 0.0, 1.0], dtype=xyz.dtype, device=xyz.device)
    w_out = torch.where(good, w_vec, flat)
    h_out = torch.where(good, intercept, standard_height)
    return w_out, h_out
