"""Host-side fitting oracles: linear regression, RANSAC plane, laser params.

Semantics mirror the reference's estimators (file:line cited per function) but
with the deterministic substitutions documented in the package docstring.
"""

from __future__ import annotations

import numpy as np


def linregress_fit(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """Least-squares slope/intercept (scipy.stats.linregress equivalent)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xm, ym = x.mean(), y.mean()
    dx = x - xm
    denom = np.sum(dx * dx)
    slope = np.sum(dx * (y - ym)) / denom
    return float(slope), float(ym - slope * xm)


def polyfit2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Degree-2 polynomial least squares, highest power first (np.polyfit)."""
    return np.polyfit(np.asarray(x, np.float64), np.asarray(y, np.float64), 2)


def _mad(y: np.ndarray) -> float:
    """Median absolute deviation — sklearn RANSACRegressor's default
    residual_threshold (planes.py:35 passes none)."""
    return float(np.median(np.abs(y - np.median(y))))


def ransac_plane(
    points_xyz: np.ndarray,
    trials: int = 64,
    seed: int = 0,
    standard_height: float = -1.55,
) -> tuple[np.ndarray, float]:
    """RANSAC ground-plane fit with the reference's crop and fallback.

    Mirrors `tools/wet_ground/planes.py:12-50`: crop points near the expected
    road surface, RANSAC-fit z = a*x + b*y + c (squared residual vs MAD(z)
    threshold — the reference passes loss='squared_loss' while sklearn's
    default threshold is MAD(y), an inconsistency we reproduce), refit on the
    best trial's inliers, return unit normal w = [a, b, -1]/|.| and *raw*
    intercept h (the reference does not rescale h by |w|).
    """
    pc = np.asarray(points_xyz)
    valid = (
        (pc[:, 2] < -1.55)
        & (pc[:, 2] > -1.86 - 0.01 * pc[:, 0])
        & (pc[:, 0] > 10)
        & (pc[:, 0] < 70)
        & (pc[:, 1] > -3)
        & (pc[:, 1] < 3)
    )
    p = pc[valid][:, :3].astype(np.float64)
    if p.shape[0] <= 3:
        return np.array([0.0, 0.0, 1.0]), standard_height

    x, z = p[:, :2], p[:, 2]
    thresh = _mad(z)
    rng = np.random.default_rng(seed)
    n = len(p)

    best_inliers = None
    best_count = -1
    for _ in range(trials):
        idx = rng.integers(0, n, size=3)
        a = np.column_stack([x[idx], np.ones(3)])
        try:
            coef = np.linalg.solve(a, z[idx])
        except np.linalg.LinAlgError:
            continue
        resid = z - (x @ coef[:2] + coef[2])
        inliers = resid**2 < thresh
        c = int(inliers.sum())
        if c > best_count:
            best_count = c
            best_inliers = inliers

    if best_inliers is None or best_inliers.sum() < 3:
        return np.array([0.0, 0.0, 1.0]), standard_height

    a = np.column_stack([x[best_inliers], np.ones(int(best_inliers.sum()))])
    coef, *_ = np.linalg.lstsq(a, z[best_inliers], rcond=None)
    w = np.array([coef[0], coef[1], -1.0])
    h = float(coef[2])
    w = w / np.linalg.norm(w)
    return w, h


def ransac_polyfit(
    x, y, order=3, n=15, k=100, t=0.1, d=15, f=0.8, rng=None
):
    """Literal RANSAC polynomial fit (`tools/wet_ground/augmentation.py:171-193`).

    Starts from the full-data polyfit; each trial fits `n` random samples,
    accepts if > d inliers AND > f fraction inliers, and keeps the inlier
    refit with the lowest absolute error. The reference draws trial indices
    from the GLOBAL np.random state (np.random.randint); with rng=None this
    does the same, so `np.random.seed(s)` reproduces its exact draw sequence
    (golden-tested in tests/test_reference_golden.py). Pass an
    np.random.Generator to decouple from global state (different stream).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    draw = (
        (lambda: np.random.randint(len(x), size=n))
        if rng is None
        else (lambda: rng.integers(len(x), size=n))
    )
    bestfit = np.polyfit(x, y, order)
    besterr = np.sum(np.abs(np.polyval(bestfit, x) - y))
    for _ in range(k):
        maybe = draw()
        model = np.polyfit(x[maybe], y[maybe], order)
        inl = np.abs(np.polyval(model, x) - y) < t
        if inl.sum() > d and inl.sum() > len(x) * f:
            better = np.polyfit(x[inl], y[inl], order)
            err = np.sum(np.abs(np.polyval(better, x[inl]) - y[inl]))
            if err < besterr:
                bestfit, besterr = better, err
    return bestfit


def noise_floor_bins(
    distance: np.ndarray,
    normalized_intensities: np.ndarray,
    n_points: int,
    bins: tuple[int, int] = (50, 2555),
    d_range: tuple[float, float] = (10.0, 70.0),
    device_semantics: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Minimum-intensity-per-distance-bin estimator.

    Mirrors `tools/wet_ground/augmentation.py:232-241`: 2-D histogram of
    (distance, intensity) with intensity range (5, max); empty bins set to the
    point count; per distance row pick the intensity bin with the minimal
    count (see package docstring re argpartition), keep rows whose bin edge
    value exceeds 5; return (bin-center distances, intensity edge values).
    """
    hist, xedges, yedges = np.histogram2d(
        distance,
        normalized_intensities,
        bins=bins,
        range=(d_range, (5, np.abs(np.max(normalized_intensities)))),
    )
    hist[hist == 0] = n_points
    if device_semantics:
        # the TPU pipeline's pinned tie-break: first minimal-count bin
        # (ops/laser.py:noise_floor_rows) — see PARITY.md for measured deltas
        ymins = np.argmin(hist, axis=1)
    else:
        # literal argpartition(…, 2)[:, 0] (augmentation.py:237): NOT argmin —
        # position 0 only holds *one of the two smallest* bins, and with the
        # massive tie plateau (empty bins := n_points) the selected index
        # follows introselect's deterministic-but-arbitrary order.
        # Golden-tested in tests/test_reference_golden.py.
        ymins = np.argpartition(hist, 2, axis=1)[:, 0]
    min_vals = yedges[ymins]
    sel = min_vals > 5
    x = (xedges[:-1][sel] + xedges[1:][sel]) / 2
    return x, min_vals[sel]


def estimate_laser_parameters(
    ground_points: np.ndarray,
    incident_angle: np.ndarray,
    power_factor: float = 15.0,
    noise_floor: float = 0.7,
    estimation_method: str = "linear",
    device_semantics: bool = False,
):
    """Relative output power + adaptive noise threshold per ground point.

    Mirrors `tools/wet_ground/augmentation.py:195-266` (sans plotting):
    intensities normalized by cos(incident); power fitted linear (or poly-2)
    vs distance, scaled by power_factor; noise floor from the 2-D histogram
    minimum fit, scaled by noise_floor.

    device_semantics=True swaps the two reference quirks the TPU pipeline
    cannot (sensibly) reproduce for their pinned equivalents: histogram
    row-minimum tie-break = first index (vs introselect's argpartition order)
    and poly noise fit = plain degree-2 polyfit with the >3-rows fallback (vs
    an unseeded global-RNG RANSAC). Literal mode is golden-tested against the
    reference; the device deviation is quantified in PARITY.md.
    """
    intens = ground_points[:, 3] / np.cos(incident_angle)
    distance = np.linalg.norm(ground_points[:, :3], axis=1)
    if len(intens) < 3:
        return None, None, None

    if estimation_method == "linear":
        p = linregress_fit(distance, intens)
        relative_output = power_factor * (p[0] * distance + p[1])
    elif estimation_method == "poly":
        p = polyfit2(distance, intens)
        relative_output = power_factor * np.polyval(p, distance)
    else:
        raise ValueError(estimation_method)

    x, min_vals = noise_floor_bins(
        distance, intens, len(ground_points), device_semantics=device_semantics
    )
    if estimation_method == "poly":
        if device_semantics:
            pmin = polyfit2(x, min_vals) if len(min_vals) > 3 else p
        else:
            # literal: ALWAYS ransac_polyfit (global np.random), no length
            # guard (augmentation.py:244-247)
            pmin = ransac_polyfit(x, min_vals, order=2)
        threshold = noise_floor * np.polyval(pmin, distance)
    else:
        pmin = linregress_fit(x, min_vals) if len(min_vals) > 3 else p
        threshold = noise_floor * (pmin[0] * distance + pmin[1])

    return relative_output, threshold, p
