"""Literal-semantics wet-ground augmentation oracle (host NumPy).

Mirrors `tools/wet_ground/augmentation.py:25-161` +
`tools/wet_ground/phy_equations.py:12-108`.
"""

from __future__ import annotations

import numpy as np

from lidar_snow_sim_tpu_torch.oracle.fitting import estimate_laser_parameters, ransac_plane


def fresnel_power(ain, nair=1.0003, nw=1.33):
    """Fresnel power reflection/transmission coefficients air->water
    (phy_equations.py:35-67). Returns rs, ts, rp, tp, aout."""
    aout = np.arcsin(np.clip(np.sin(ain) * nair / nw, -1, 1))
    power_frac = np.cos(ain) * nair / nw / np.cos(aout)

    rs = (nair * np.cos(ain) - nw * np.cos(aout)) / (
        nair * np.cos(ain) + nw * np.cos(aout)
    )
    ts = 2 * nair * np.cos(ain) / (nair * np.cos(ain) + nw * np.cos(aout))
    rp = (nw * np.cos(ain) - nair * np.cos(aout)) / (
        nw * np.cos(ain) + nair * np.cos(aout)
    )
    tp = 2 * nair * np.cos(ain) / (nw * np.cos(ain) + nair * np.cos(aout))

    return rs**2, ts**2 / power_frac, rp**2, tp**2 / power_frac, aout


def total_transmittance_from_ground(ain, nair=1.0003, nw=1.33, rho=0.9):
    """Two-interface (air->water->ground->water->air) power transmittance with
    the multiple-internal-reflection series t*rho*t' / (1 - rho*r')
    (phy_equations.py:70-108)."""
    ras, tas, rap, tap, aaout = fresnel_power(ain, nair=nair, nw=nw)
    rws, tws, rwp, twp, _ = fresnel_power(aaout, nair=nw, nw=nair)

    ts = tas * rho * tws / (1 - rho * rws)
    tp = tap * rho * twp / (1 - rho * rwp)
    return ras, ts, rap, tp, aaout


def ground_water_augmentation(
    pointcloud: np.ndarray,
    water_height: float = 0.001,
    pavement_depth: float = 0.0012,
    noise_floor: float = 0.7,
    power_factor: float = 15.0,
    estimation_method: str = "linear",
    flat_earth: bool = False,
    delta: float = 0.5,
    replace: bool = True,
    plane: tuple | None = None,
    device_semantics: bool = False,
) -> np.ndarray:
    """Wet-ground reflectance augmentation (augmentation.py:25-161).

    Output ordering matches the reference: non-ground points first (original
    order), then surviving ground points (original order) with new intensities
    and label column 1. If fewer than 1000 ground points, the input is
    returned unchanged.
    """
    if plane is None:
        w, h = ransac_plane(pointcloud[:, :3])
    else:
        w, h = plane
    w = np.asarray(w, dtype=np.float64)

    hog = pointcloud[:, :3] @ w
    ground = ((hog + h) < delta) & ((hog + h) > -delta)
    planes_pc = np.hstack([pointcloud[ground], hog[ground, None]])
    if planes_pc.shape[0] < 1000:
        return pointcloud

    if flat_earth:
        incident = np.arccos(
            -planes_pc[:, 2] / np.linalg.norm(planes_pc[:, :3], axis=1)
        )
    else:
        incident = np.arccos(
            (planes_pc[:, :3] @ w)
            / (np.linalg.norm(planes_pc[:, :3], axis=1) * np.linalg.norm(w))
        )

    relative_output, threshold, _ = estimate_laser_parameters(
        planes_pc,
        incident,
        noise_floor=noise_floor,
        estimation_method=estimation_method,
        power_factor=power_factor,
        device_semantics=device_semantics,
    )

    reflectivities = planes_pc[:, 3] / np.cos(incident) / relative_output

    _, ts, _, tp, _ = total_transmittance_from_ground(
        incident, rho=np.clip(reflectivities, 0.05, 1)
    )
    t = np.maximum(tp, ts)

    f = np.clip(water_height / pavement_depth, 0, 1)
    tw = (1 - f) * reflectivities + f * t / incident

    new_int = np.clip(
        relative_output * np.cos(incident) * tw, 0, planes_pc[:, 3]
    )
    new_int[new_int < threshold * np.cos(incident)] = 0

    keep = new_int > threshold * np.cos(incident)

    non_ground = pointcloud[~ground]
    kept = planes_pc[keep][:, :5]
    out = np.zeros((len(non_ground) + int(keep.sum()), 5))
    out[: len(non_ground)] = non_ground
    out[len(non_ground):] = kept
    out[len(non_ground):, 3] = new_int[keep]

    if replace:
        out[:, 4] = 0
    out[len(non_ground):, 4] = 1
    return out
