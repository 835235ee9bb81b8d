"""DROR (Dynamic Radius Outlier Removal) de-snowing on tensors
(counterpart of `lidar_snow_sim_tpu/models/dror.py`, the cadc_devkit
surface: ``dynamic_radius_outlier_filter``, ``get_cube_mask``,
``DROR_LEVELS``).

A point is kept iff at least `k_min` other points lie within its search
radius sr = max(sr_min, beta * alpha_rad * r). Distances are the f32
expansion |x_i|^2 + |x_j|^2 - 2 x_i . x_j, with the cross term written as
three elementwise products: no matrix unit, and so no TF32, can reach it,
whatever the caller's `allow_tf32` flags.

Two searches, as in the JAX package:

- `dror_full`: every point against the whole cloud, a few rows at a time;
- `dror_windowed` (the default): points sorted by azimuth, the top and
  bottom `margin` real points copied across the +-pi seam, and each block
  of `block` sorted points compared with the window of sorted points its
  angular reach can touch (asin(sr / rho), widened to pi where sr >= rho).
  The windows are gathered by index arithmetic and processed a group of
  blocks at a time, so the distance tile stays small. Every way the static
  window and margin could be exceeded is counted as an overflow.

`dynamic_radius_outlier_filter` runs the windowed search, grows the window
once on an overflow, and then runs the full search: the JAX package's
exactness rule. Pairs within ~1e-3 m of the radius boundary can flip
between the two searches (and between packages): the f32 expansion's
cancellation error.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.ops.geometry import norm3

# Snow-severity bands by the number of DROR-flagged points inside the
# analysis cube (`create_image_sets.DROR_LEVELS`; "heavy" is open-ended).
DROR_LEVELS = {
    "light": (0, 249),
    "medium": (250, 499),
    "heavy": (500, 10**9),
}

# the severity-analysis cube (cadc_devkit's get_cube_mask region)
CUBE_X = (0.0, 20.0)
CUBE_Y = (-10.0, 10.0)
CUBE_Z = (-3.0, 3.0)

_TILE = 1 << 23   # distance-tile elements per step (32 MB of f32)


def get_cube_mask(pc: np.ndarray) -> np.ndarray:
    """Boolean mask of points inside the severity-analysis cube."""
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    return (
        (x >= CUBE_X[0]) & (x <= CUBE_X[1])
        & (y >= CUBE_Y[0]) & (y <= CUBE_Y[1])
        & (z >= CUBE_Z[0]) & (z <= CUBE_Z[1])
    )


def snow_level(num_snow_points: int) -> str:
    for name, (lo, hi) in DROR_LEVELS.items():
        if lo <= num_snow_points <= hi:
            return name
    return "heavy"


def _count_within(b_xyz, b_sq, b_sr2, w_xyz, w_sq, w_valid):
    """Per row of b: the number of valid w columns with d^2 <= sr^2, d^2 =
    |b|^2 + |w|^2 - 2 b.w (any leading batch dimensions)."""
    cross = (b_xyz[..., :, None, 0] * w_xyz[..., None, :, 0]
             + b_xyz[..., :, None, 1] * w_xyz[..., None, :, 1]
             + b_xyz[..., :, None, 2] * w_xyz[..., None, :, 2])
    d2 = b_sq[..., :, None] + w_sq[..., None, :] - 2.0 * cross
    inside = (d2 <= b_sr2[..., :, None]) & w_valid[..., None, :]
    return inside.sum(dim=-1)


def dror_full(xyz, mask, coef: float, k_min: int, sr_min: float):
    """(N,) keep mask: every point against the whole cloud (`_dror_kernel`,
    dror.py:84-113). coef = f32(beta) * f32(alpha_rad)."""
    n = xyz.shape[0]
    sq = (xyz * xyz).sum(dim=-1)
    sr = torch.clamp(coef * norm3(xyz), min=sr_min)
    sr2 = sr * sr
    rows = max(1, _TILE // max(n, 1))
    counts = torch.cat([
        _count_within(xyz[i:i + rows], sq[i:i + rows], sr2[i:i + rows],
                      xyz, sq, mask)
        for i in range(0, n, rows)
    ]) - 1                                # the self-match counts once
    return mask & (counts >= k_min)


def dror_windowed(xyz, mask, coef: float, k_min: int, sr_min: float, *,
                  block: int, window: int, margin: int):
    """((N,) keep mask, 0-dim overflow count): the azimuth-windowed search
    (`_dror_kernel_windowed`, dror.py:119-229). Exact whenever the overflow
    is 0. N must be a multiple of `block`; padding rows have mask False."""
    n = xyz.shape[0]
    dev = xyz.device
    margin = min(margin, n)
    window = min(window, n + 2 * margin)
    n_ext = n + 2 * margin

    # azimuth key; masked padding parks at +pi
    theta = torch.where(mask, torch.atan2(xyz[:, 1], xyz[:, 0]), math.pi)
    th_s, order = torch.sort(theta, stable=True)
    xyz_s = xyz[order]
    m_s = mask[order]
    xs, ys, zs = xyz_s[:, 0], xyz_s[:, 1], xyz_s[:, 2]
    sq_s = xs * xs + ys * ys + zs * zs
    rho_s = torch.sqrt(xs * xs + ys * ys)
    sr_s = torch.clamp(coef * torch.sqrt(sq_s), min=sr_min)
    sr2_s = sr_s * sr_s
    # angular reach of an in-radius neighbour: asin(sr / rho) for sr < rho,
    # any azimuth where the radius reaches past the horizontal range
    reach = torch.where(
        sr_s >= rho_s, math.pi,
        torch.arcsin(torch.clamp(sr_s / torch.clamp(rho_s, min=1e-30),
                                 max=1.0)),
    )
    reach = torch.where(m_s, reach, 0.0)

    # sorted-extended arrays: the top/bottom `margin` REAL points copied
    # across the seam
    n_real = mask.sum()
    lo_idx = torch.clamp(n_real - margin, min=0) + torch.arange(margin,
                                                                device=dev)
    ext = torch.cat([lo_idx, torch.arange(n, device=dev),
                     torch.arange(margin, device=dev)])
    th_ext = torch.cat([th_s[lo_idx] - 2 * math.pi, th_s,
                        th_s[:margin] + 2 * math.pi])
    xyz_ext = xyz_s[ext]
    m_ext = m_s[ext]
    sq_ext = (xyz_ext * xyz_ext).sum(dim=-1)

    nb = n // block
    th_blk = th_s.reshape(nb, block)
    m_blk = m_s.reshape(nb, block)
    has_real = m_blk.any(dim=1)
    # block bounds over real rows only
    th_lo_b = torch.where(m_blk, th_blk, math.inf).amin(dim=1)
    th_hi_b = torch.where(m_blk, th_blk, -math.inf).amax(dim=1)
    reach_blk = reach.reshape(nb, block).amax(dim=1)
    lo_theta = th_lo_b - reach_blk
    hi_theta = th_hi_b + reach_blk
    lo = torch.searchsorted(th_ext, lo_theta, right=False)
    hi = torch.searchsorted(th_ext, hi_theta, right=True)
    lo = torch.where(has_real, lo, 0)
    hi = torch.where(has_real, hi, 0)          # dead blocks: empty window
    width = hi - lo

    # every exactness hazard is counted: the window capacity, margin
    # copies too shallow for the widest seam reach, and a >= 2 pi span
    # that would see both copies of one point
    live = has_real & (reach_blk > 0)
    ovf = (torch.clamp(width - window, min=0).sum()
           + (live & (lo_theta < th_ext[0])).sum()
           + (live & (hi_theta > th_ext[-1])).sum()
           + (has_real & (hi_theta - lo_theta >= 2 * math.pi)).sum())

    # each block's window: ext indices [start, start + window), valid
    # exactly on [lo, hi) (a point and its seam copy share xyz)
    start = torch.clamp(lo, max=n_ext - window)
    col = torch.arange(window, device=dev)
    b_xyz = xyz_s.reshape(nb, block, 3)
    b_sq = sq_s.reshape(nb, block)
    b_sr2 = sr2_s.reshape(nb, block)
    group = max(1, _TILE // (block * window))
    counts = []
    for g0 in range(0, nb, group):
        sl = slice(g0, min(g0 + group, nb))
        w_idx = start[sl, None] + col
        off = (lo - start)[sl, None]
        w_valid = m_ext[w_idx] & (col >= off) & (col < off + width[sl, None])
        counts.append(_count_within(b_xyz[sl], b_sq[sl], b_sr2[sl],
                                    xyz_ext[w_idx], sq_ext[w_idx], w_valid))
    # the block's own rows lie inside [lo, hi): self counts once
    counts = torch.cat(counts).reshape(-1) - 1
    keep_sorted = m_s & (counts >= k_min)
    keep = torch.zeros(n, dtype=torch.bool, device=dev)
    keep[order] = keep_sorted
    return keep, ovf


def dynamic_radius_outlier_filter(
    pc: np.ndarray,
    alpha: float = 0.45,
    beta: float = 3.0,
    k_min: int = 3,
    sr_min: float = 0.04,
    block: int = 1024,
    window: int = 2048,
    margin: int = 1024,
    device="cuda",
) -> np.ndarray:
    """Keep-mask over an (N, >=3) cloud; True = inlier (not snow). alpha in
    degrees, sr_min in meters (the reference's live-PCL signature), plus
    `device` (the card unless the CPU is asked for). The windowed search runs first (blocks of min(block, 128));
    a counted overflow grows the window once, and a second one runs the
    full search, so every in-radius pair is compared. ``window=0`` forces
    the full search."""
    device = resolve_device(device)
    pc = np.asarray(pc)
    n = pc.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    coef = float(np.float32(beta) * np.float32(math.radians(alpha)))
    sr_min = float(np.float32(sr_min))
    cap = ((n + block - 1) // block) * block
    xyz = np.full((cap, 3), 1e6, np.float32)   # padding: never a neighbour
    xyz[:n] = pc[:, :3]
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = True
    xyz = torch.as_tensor(xyz, device=device)
    mask = torch.as_tensor(mask, device=device)
    if window:
        wblock = min(block, 128)
        wcap = ((n + wblock - 1) // wblock) * wblock
        for w in (window, 2 * window):
            if w >= wcap + 2 * min(margin, wcap):
                break   # the window covers the whole cloud: full-N is the same
            keep, ovf = dror_windowed(
                xyz[:wcap], mask[:wcap], coef, k_min, sr_min,
                block=wblock, window=w, margin=margin,
            )
            if int(ovf) == 0:
                return keep[:n].cpu().numpy()
    return dror_full(xyz, mask, coef, k_min, sr_min)[:n].cpu().numpy()


def dror_snow_stats(pc: np.ndarray, **kwargs):
    """(num_snow_in_cube, severity_level): the viewer's severity readout."""
    cube = pc[get_cube_mask(pc)]
    if len(cube) == 0:
        return 0, "light"
    keep = dynamic_radius_outlier_filter(cube, **kwargs)
    num_snow = int((~keep).sum())
    return num_snow, snow_level(num_snow)


# --- precomputed-index fallback (the reference's DROR.zip path): per-frame
# pickles of snow-point indices under {root}/alpha_0.45/all/{sensor}/
# {signal}/{variant}/{frame}.pkl, variant "full" for the filter mask and
# "crop" for the severity count


def _pickle_path(root, sensor, signal, variant, filename):
    from pathlib import Path

    name = Path(filename).name.replace(".bin", "")
    return (
        Path(root) / "alpha_0.45" / "all" / sensor / signal / variant
        / f"{name}.pkl"
    )


def precomputed_dror_mask(
    root, sensor: str, signal: str, variant: str, before: int, filename: str
) -> np.ndarray:
    """Keep-mask from a precomputed snow-index pickle: ones(before) with the
    pickled indices cleared. Raises FileNotFoundError when it is absent."""
    import pickle

    with open(_pickle_path(root, sensor, signal, variant, filename), "rb") as f:
        snow_indices = pickle.load(f)
    mask = np.ones(before, dtype=bool)
    mask[snow_indices] = False
    return mask


def precomputed_snow_severity(
    root, sensor: str, signal: str, filename: str
) -> tuple[int, str]:
    """(num_snow, severity label) from the crop-variant pickle; (-1, "file
    not found") when it is absent."""
    import pickle

    path = _pickle_path(root, sensor, signal, "crop", filename)
    if not path.exists():
        return -1, "file not found"
    with open(path, "rb") as f:
        num_snow = len(pickle.load(f))
    return num_snow, snow_level(num_snow)
