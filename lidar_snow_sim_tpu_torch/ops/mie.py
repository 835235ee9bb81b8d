"""Mie scattering efficiencies for spherical water droplets (host-side bake;
the port's copy of `lidar_snow_sim_tpu/ops/mie.py`, held bitwise against it
by tests/test_torch_host.py).

Replaces the PyMieScatt dependency of the reference's `lib/LISA` submodule
(`pointcloud_viewer.py:45,2896-2903` consumes LISA, which integrates Mie
cross-sections over a drop-size distribution). The Mie
series is evaluated **once on host** over a log-spaced diameter grid and baked
into a LUT (`MieLUT`); on-device kernels only ever interpolate the LUT — no
special functions on the device.

Implementation: standard Bohren–Huffman series with the logarithmic-derivative
downward recurrence (the same algorithm PyMieScatt implements). Valid across
the full range used here: fog droplets (µm) through raindrops (mm) at
λ = 905 nm, i.e. size parameters up to ~3·10⁴.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# complex refractive index of liquid water at 905 nm (Hale & Querry 1973)
WATER_M_905NM = complex(1.327, 4.86e-7)


def mie_efficiencies(m: complex, wavelength_um: float, diameter_um: float):
    """(Qext, Qsca, Qback) for one sphere; Bohren–Huffman series.

    wavelength/diameter in µm (any consistent unit works).
    """
    x = np.pi * diameter_um / wavelength_um
    if x <= 0:
        return 0.0, 0.0, 0.0
    nmax = int(np.round(x + 4.0 * x ** (1.0 / 3.0) + 2.0))
    mx = m * x
    nmx = int(np.round(max(nmax, abs(mx)) + 16))

    # logarithmic derivative D_n(mx), downward recurrence
    d = np.zeros(nmx + 1, dtype=complex)
    for n in range(nmx, 0, -1):
        d[n - 1] = n / mx - 1.0 / (d[n] + n / mx)

    n = np.arange(1, nmax + 1)
    # Riccati–Bessel psi, chi by upward recurrence
    psi = np.zeros(nmax + 1)
    chi = np.zeros(nmax + 1)
    psi_m1, psi[0] = np.cos(x), np.sin(x)          # psi_{-1}, psi_0
    chi_m1, chi[0] = -np.sin(x), np.cos(x)         # chi_{-1}, chi_0
    for k in range(1, nmax + 1):
        psi[k] = (2 * k - 1) / x * psi[k - 1] - (psi[k - 2] if k >= 2 else psi_m1)
        chi[k] = (2 * k - 1) / x * chi[k - 1] - (chi[k - 2] if k >= 2 else chi_m1)
    xi = psi - 1j * chi

    dn = d[1 : nmax + 1]
    psi_n, psi_nm1 = psi[1:], psi[:-1]
    xi_n, xi_nm1 = xi[1:], xi[:-1]
    da = dn / m + n / x
    db = dn * m + n / x
    a = (da * psi_n - psi_nm1) / (da * xi_n - xi_nm1)
    b = (db * psi_n - psi_nm1) / (db * xi_n - xi_nm1)

    two_n1 = 2 * n + 1
    qext = 2.0 / x**2 * np.sum(two_n1 * (a + b).real)
    qsca = 2.0 / x**2 * np.sum(two_n1 * (np.abs(a) ** 2 + np.abs(b) ** 2))
    qback = (
        1.0 / x**2 * np.abs(np.sum(two_n1 * (-1.0) ** n * (a - b))) ** 2
    )
    return float(qext), float(qsca), float(qback)


@dataclasses.dataclass(frozen=True)
class MieLUT:
    """Log-diameter LUT of Mie efficiencies, interp-ready for device kernels."""

    diameters_mm: np.ndarray  # (K,) ascending
    qext: np.ndarray          # (K,)
    qback: np.ndarray         # (K,)
    wavelength_nm: float

    def interp_qext(self, d_mm: np.ndarray) -> np.ndarray:
        return np.interp(d_mm, self.diameters_mm, self.qext)

    def interp_qback(self, d_mm: np.ndarray) -> np.ndarray:
        return np.interp(d_mm, self.diameters_mm, self.qback)


_LUT_CACHE: dict[tuple, MieLUT] = {}


def bake_mie_lut(
    wavelength_nm: float = 905.0,
    d_min_mm: float = 5e-4,
    d_max_mm: float = 20.0,
    n_points: int = 96,
    m: complex = WATER_M_905NM,
) -> MieLUT:
    """Bake (once per process) the water-droplet Mie LUT at the given λ."""
    key = (wavelength_nm, d_min_mm, d_max_mm, n_points, m)
    if key in _LUT_CACHE:
        return _LUT_CACHE[key]
    d_mm = np.geomspace(d_min_mm, d_max_mm, n_points)
    lam_um = wavelength_nm * 1e-3
    qe = np.empty(n_points)
    qb = np.empty(n_points)
    for i, d in enumerate(d_mm):
        qe[i], _, qb[i] = mie_efficiencies(m, lam_um, d * 1e3)
    lut = MieLUT(
        diameters_mm=d_mm, qext=qe, qback=qb, wavelength_nm=wavelength_nm
    )
    _LUT_CACHE[key] = lut
    return lut
