"""Fresnel optics for wet-ground reflectance on tensors (counterpart of
`lidar_snow_sim_tpu/ops/fresnel.py`; reference
`tools/wet_ground/phy_equations.py:12-108`): Snell refraction air to water,
power reflection and transmission at each interface, and the two-interface
internal-reflection series t * rho * t' / (1 - rho * r').
"""

from __future__ import annotations

import torch

from lidar_snow_sim_tpu_torch.ops.f32 import div


def fresnel_amplitude(ain, nair: float = 1.0003, nw: float = 1.33):
    """Amplitude coefficients rs, ts, rp, tp and the refracted angle."""
    aout = torch.arcsin(torch.clamp(div(torch.sin(ain) * nair, nw), -1.0, 1.0))
    ci, co = torch.cos(ain), torch.cos(aout)
    rs = (nair * ci - nw * co) / (nair * ci + nw * co)
    ts = 2 * nair * ci / (nair * ci + nw * co)
    rp = (nw * ci - nair * co) / (nw * ci + nair * co)
    tp = 2 * nair * ci / (nw * ci + nair * co)
    return rs, ts, rp, tp, aout


def fresnel_power(ain, nair: float = 1.0003, nw: float = 1.33):
    """Power coefficients Rs, Ts, Rp, Tp and the refracted angle."""
    rs, ts, rp, tp, aout = fresnel_amplitude(ain, nair, nw)
    power_frac = div(torch.cos(ain) * nair, nw) / torch.cos(aout)
    return rs**2, ts**2 / power_frac, rp**2, tp**2 / power_frac, aout


def bathymetric_scattering(
    ain,
    depth: float = 0.002,
    nair: float = 1.0003,
    nw: float = 1.33,
    beta: float = 0.001,
):
    """Two-way Beer-Lambert absorption along the refracted path through a
    thin water layer, weighted by the cos^2 incidence falloff
    (phy_equations.py:111-126)."""
    aout = torch.arcsin(torch.clamp(div(torch.sin(ain) * nair, nw), -1.0, 1.0))
    return torch.exp(
        torch.full_like(aout, -2.0 * beta * depth) / torch.cos(aout)
    ) * torch.cos(ain) ** 2


def lidar_measurement(
    distances, height: float = 1.55, i_out: float = 1.0, rho: float = 0.12,
    natm: float = 1.0, c: float = 1.0,
):
    """Flat-earth received intensity (phy_equations.py:250-268):
    I_rec = I_out * cos(arctan(d / h)) * rho * natm * C."""
    angles = torch.arctan(div(torch.as_tensor(distances), height))
    return i_out * torch.cos(angles) * rho * natm * c


def total_transmittance_from_ground(
    ain, nair: float = 1.0003, nw: float = 1.33, rho=0.9
):
    """Round-trip power transmittance off wet ground, both polarizations:
    air to water, ground reflection (rho), water to air, summed over the
    internal water-air reflections. Returns Rs, Ts, Rp, Tp, refracted
    angle."""
    ras, tas, rap, tap, aaout = fresnel_power(ain, nair=nair, nw=nw)
    rws, tws, rwp, twp, _ = fresnel_power(aaout, nair=nw, nw=nair)
    ts = tas * rho * tws / (1 - rho * rws)
    tp = tap * rho * twp / (1 - rho * rwp)
    return ras, ts, rap, tp, aaout
