"""LISA light-scattering augmentation (rain, snow, fog) on tensors
(counterpart of `lidar_snow_sim_tpu/models/lisa.py`).

Per point, the `k1` nearest droplets of the beam cone are sampled exactly
by radial order statistics, plus the `k2` largest-diameter droplets of the
residual population beyond them; the strongest return among the droplets
and the hard target wins. A residual power bound counts, in
`droplet_overflow`, every point whose outcome a non-sampled droplet could
have changed; the host wrapper then doubles both capacities and reruns.

The host physics (drop-size distributions, extinction coefficient, droplet
density, the sampling tables) is numpy, copied from the JAX module because
that module imports jax. `lisa_augment_core` is the device part, with its
random draws injected (`lisa_draws`): `lisa_droplets` samples the
candidates, then their hot lookup, Qback at every (point, droplet)
candidate, always goes through `ops/lut_lookup.lut_lookup_pairs`: kernel L1
on the card, its plain version on the CPU. The JAX package's `mxu_lookup`
chooses between its TPU kernel and XLA's gather; the port accepts it and
ignores it.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.ops.mie import WATER_M_905NM, bake_mie_lut
from lidar_snow_sim_tpu_torch.utils.pointcloud import pad_cloud
from lidar_snow_sim_tpu_torch.ops.geometry import norm3
from lidar_snow_sim_tpu_torch.ops.lut_lookup import lut_lookup_pairs

logger = logging.getLogger(__name__)

# Shettle & Fenn 1979 modified-gamma fog presets (see LISA.Nd):
# name -> (a [cm^-3 um^-(alpha+1)], alpha, b [um^-1]) over droplet RADIUS.
_FOG_PRESETS = {
    "strong_advection": (0.027, 3, 0.3),
    "moderate_radiation": (607.5, 6, 3.0),
}
_SNOW_MODES = ("snow", "gunn", "sekhon")
_ATTEMPTS = 6


class LisaResult(NamedTuple):
    points: torch.Tensor   # (N, 6): x, y, z, intensity, label, intensity_diff
    keep: torch.Tensor     # (N,) label > 0
    num_lost: torch.Tensor
    num_scattered: torch.Tensor
    num_attenuated: torch.Tensor
    droplet_overflow: torch.Tensor  # int32: points where a non-sampled
    # residual droplet's power bound exceeds the winner (capacity too small)


class LisaTables(NamedTuple):
    """`LISA._dsd_tables` on one device: the truncated-exponential inverse
    CDF (lam, e_lo, e_span; 0-dim), the fog inverse-CDF pairs (Q, 2), the
    Qback knot pairs (G-1, 2) and the power-bound knot pairs (G-1, 4)."""

    lam: torch.Tensor
    e_lo: torch.Tensor
    e_span: torch.Tensor
    inv_pairs: torch.Tensor
    qb_pairs: torch.Tensor
    cap_pairs: torch.Tensor


class LisaDroplets(NamedTuple):
    """The sampled candidates of `lisa_droplets`: per point the range d,
    the (k1 + k2) droplet ranges, diameters [mm] and liveness, and what the
    residual bound needs (the k1-th nearest range, the smallest tail
    diameter, whether a residual population exists)."""

    d: torch.Tensor
    r: torch.Tensor
    d_mm: torch.Tensor
    live: torch.Tensor
    r_k1: torch.Tensor
    d_tail: torch.Tensor
    residual: torch.Tensor


class LisaCoreConfig(NamedTuple):
    """The scalars `lisa_augment_core` reads from a LISA instance."""

    mode: str
    log_d0: float
    inv_dlog: float
    gm1: int              # dsd_points - 1
    beam_divergence: float
    r_min: float
    r_max: float
    range_accuracy: float


def lisa_tables_to_torch(tables, device) -> LisaTables:
    """The first six entries of a `_dsd_tables` tuple (this package's, or the
    JAX package's as numpy, whose seventh, the bf16 parts table, is
    dropped) as f32 tensors on `device`."""
    return LisaTables(*(
        torch.tensor(np.asarray(t, np.float32), device=device)
        for t in tuple(tables)[:6]
    ))


def lisa_draws(n: int, k1: int, k2: int, generator: torch.Generator):
    """The five random streams of one LISA call, on the generator's device:
    Exp(1) (n, k1) and (n, k2) for the nearest-droplet and tail arrivals,
    U[0, 1) (n, k1) droplet quantiles and (n, k2) tail positions, and the
    (n,) standard-normal range jitter."""
    dev = generator.device
    e1 = torch.empty((n, k1), device=dev).exponential_(generator=generator)
    e2 = torch.empty((n, k2), device=dev).exponential_(generator=generator)
    u1 = torch.rand((n, k1), generator=generator, device=dev)
    u2 = torch.rand((n, k2), generator=generator, device=dev)
    g = torch.randn((n,), generator=generator, device=dev)
    return e1, e2, u1, u2, g


def _knot_lerp(pairs, p, n_cells: int):
    """Lerp packed knot-pair rows at positions p: row i holds (y_i...,
    y_{i+1}...) interleaved; returns one value per pair of columns."""
    i = torch.clamp(p.to(torch.int32), max=n_cells - 1)
    f = (p - i.to(torch.float32))[..., None]
    rows = pairs[i.long()]
    return rows[..., 0::2] * (1.0 - f) + rows[..., 1::2] * f


def log_pos(d_mm, cfg: LisaCoreConfig):
    """Diameters [mm] as positions on the log-uniform grid, in [0, gm1]."""
    return torch.clamp((torch.log(d_mm) - cfg.log_d0) * cfg.inv_dlog, 0.0,
                       float(cfg.gm1))


def _tan_half(cfg: LisaCoreConfig) -> float:
    return float(np.tan(np.float32(cfg.beam_divergence / 2.0)))


def lisa_droplets(points, draws, density, tables: LisaTables,
                  cfg: LisaCoreConfig) -> LisaDroplets:
    """Sample each point's candidate droplets from the injected draws
    (lisa.py:348-384): the k1 nearest of its beam cone, then the k2 largest
    of the residual population beyond them."""
    e1, e2, u1, u2, _ = draws

    if cfg.mode == "fog":
        nq = tables.inv_pairs.shape[0]

        def dsd_inv_cdf(q):
            p = torch.clamp(q, 0.0, 1.0) * nq
            return _knot_lerp(tables.inv_pairs, p, nq)[..., 0]
    else:

        def dsd_inv_cdf(q):
            # exact truncated-exponential inverse CDF (no table).
            # e_lo - q * e_span cancels as q -> 1; XLA contracts it into one
            # fused multiply-add, and a second rounding would move the
            # diameter by up to 1e-3 relative. Rounded once here (the f32
            # product is exact in f64), on every device.
            arg = (tables.e_lo.double()
                   - torch.clamp(q, 0.0, 1.0).double() * tables.e_span.double())
            return -torch.log(torch.clamp(arg.float(), min=1e-38)) / tables.lam

    d = torch.clamp(norm3(points[:, :3]), min=1e-6)
    tan_h = _tan_half(cfg)
    third = 1.0 / 3.0

    # droplets in the beam cone of length d: Poisson, mean density * V,
    # V = pi/3 * (d tan(theta))^2 * d
    vol = (math.pi / 3.0) * (tan_h * d) ** 2 * d
    lam = density * vol

    # the k1 NEAREST droplets: the i-th sits at U_i = G_i / lam in cone
    # volume (G_i a unit-rate Poisson arrival) and exists iff G_i < lam
    g = torch.cumsum(e1, dim=1)
    t1 = g / torch.clamp(lam[:, None], min=1e-30)
    live1 = t1 < 1.0
    r1 = torch.clamp(d[:, None] * torch.clamp(t1, max=1.0) ** third,
                     min=cfg.r_min)
    dmm1 = dsd_inv_cdf(u1)

    # the k2 LARGEST-DIAMETER droplets of the residual population (beyond
    # the k1-th nearest): diameter order statistics at quantile 1 - H_j /
    # lam_res, positions uniform in the residual cone shell
    t_last = torch.clamp(t1[:, -1], max=1.0)
    lam_res = lam * (1.0 - t_last)
    h = torch.cumsum(e2, dim=1)
    u_res = h / torch.clamp(lam_res[:, None], min=1e-30)
    live2 = live1[:, -1:] & (u_res < 1.0)
    dmm2 = dsd_inv_cdf(1.0 - u_res)
    t2 = t_last[:, None] + (1.0 - t_last[:, None]) * u2
    r2 = torch.clamp(d[:, None] * t2 ** third, min=cfg.r_min)

    return LisaDroplets(
        d=d,
        r=torch.cat([r1, r2], dim=1),                    # (n, k1 + k2)
        d_mm=torch.cat([dmm1, dmm2], dim=1),
        live=torch.cat([live1, live2], dim=1),
        r_k1=r1[:, -1],
        d_tail=dmm2[:, -1],
        residual=live1[:, -1] & (u_res[:, -1] < 1.0),
    )


def lisa_augment_core(points, mask, draws, alpha, density,
                      tables: LisaTables, cfg: LisaCoreConfig) -> LisaResult:
    """One LISA pass over a padded (N, >=4) scan whose intensity is on the
    [0, 1] scale (`_augment_core`, lisa.py:296-478). `draws` come from
    `lisa_draws`; their widths set the capacities k1 and k2. alpha and
    density are 0-dim f32 tensors (`LISA.alpha`, `LISA.droplet_density`)."""
    xyz = points[:, :3]
    intensity = points[:, 3]
    jitter = draws[4]
    drops = lisa_droplets(points, draws, density, tables, cfg)
    d, r_drop, d_mm = drops.d, drops.r, drops.d_mm
    tan_h = _tan_half(cfg)
    p_min = 0.9 / cfg.r_max ** 2
    qback = lut_lookup_pairs(log_pos(d_mm, cfg), tables.qb_pairs)

    # droplet return: backscatter efficiency x beam-occlusion fraction,
    # two-way attenuated; occlusion = (D / beam width at r)^2 capped at 1
    beam_w = 2.0 * r_drop * tan_h * 1e3                  # mm
    occl = torch.clamp((d_mm / torch.clamp(beam_w, min=1e-9)) ** 2, 0.0, 1.0)
    p_drop = qback * occl * torch.exp(-2.0 * alpha * r_drop) / r_drop ** 2
    p_drop = torch.where(drops.live, p_drop, 0.0)
    p_hard = intensity * torch.exp(-2.0 * alpha * d) / d ** 2

    # winner by two reductions; on equal power the nearer droplet wins
    p_best = p_drop.amax(dim=1)
    r_best = torch.where(p_drop == p_best[:, None], r_drop,
                         math.inf).amin(dim=1)

    # residual bound: a non-sampled droplet has r > r_k1 and D < the tail's
    # smallest diameter, so its power is at most
    # min(Qmax(Dm), Qd2max(Dm) / w(rk)^2) * exp(-2 alpha rk) / rk^2
    rk = drops.r_k1
    caps = _knot_lerp(tables.cap_pairs, log_pos(drops.d_tail, cfg), cfg.gm1)
    q_cap, qd2_cap = caps[..., 0], caps[..., 1]
    w_rk = 2.0 * rk * tan_h * 1e3
    p_bound = (torch.minimum(q_cap, qd2_cap / torch.clamp(w_rk, min=1e-9) ** 2)
               * torch.exp(-2.0 * alpha * rk) / rk ** 2)
    overflow = (drops.residual
                & (p_bound > torch.maximum(p_best, p_hard))
                & (p_bound >= p_min))

    droplet_wins = p_best > p_hard
    p_ret = torch.where(droplet_wins, p_best, p_hard)
    lost = p_ret < p_min

    # range jitter on droplet returns (range_accuracy, LISA's sigma_r)
    r_jit = r_best + cfg.range_accuracy * jitter
    r_new = torch.minimum(torch.clamp(r_jit, min=cfg.r_min), d)
    scale = torch.where(droplet_wins & ~lost, r_new / d, 1.0)
    # lost points move to the origin (the viewer filters label != 0)
    new_xyz = torch.where(lost[:, None], 0.0, xyz * scale[:, None])
    i_new = torch.where(droplet_wins, p_best * r_new ** 2,
                        intensity * torch.exp(-2.0 * alpha * d))
    i_new = torch.where(lost, 0.0, torch.clamp(i_new, 0.0, 1.0))

    # labels: 0 lost, 1 attenuated, 2 scattered
    label = torch.where(lost, 0.0, torch.where(droplet_wins, 2.0, 1.0))
    attenuated = ~lost & ~droplet_wins
    diff = torch.where(attenuated, intensity - i_new, 0.0)
    keep = mask & ~lost
    out = torch.cat([new_xyz, i_new[:, None], label[:, None], diff[:, None]],
                    dim=1)
    i32 = torch.int32
    return LisaResult(
        points=out,
        keep=keep,
        num_lost=(mask & lost).sum().to(i32),
        num_scattered=(keep & droplet_wins).sum().to(i32),
        num_attenuated=(keep & ~droplet_wins).sum().to(i32),
        droplet_overflow=(mask & overflow).sum().to(i32),
    )


class LISA:
    """Physics-based scattering augmentation for rain, snow and fog, with
    the JAX package's constructor (the reference submodule's argument names
    and defaults) plus `device`. Random draws come from a generator on
    `device` seeded per call."""

    def __init__(
        self,
        wavelength: float = 905.0,
        mode: str = "rain",
        r_min: float = 0.9,
        r_max: float = 120.0,
        beam_divergence: float = 3e-3,
        min_diameter: float = 0.05,
        range_accuracy: float = 0.09,
        signal: str = "strongest",
        max_droplets: int = 32,
        tail_droplets: int = 8,
        dsd_points: int = 128,
        fog_preset: str = "strong_advection",
        show_progressbar: bool = False,
        mxu_lookup: str | bool = "auto",   # accepted for API parity
        device: str | torch.device = "cuda",
    ):
        self.wavelength = wavelength
        self.mode = mode
        self.r_min = r_min
        self.r_max = r_max
        self.beam_divergence = beam_divergence
        self.min_diameter = min_diameter
        self.range_accuracy = range_accuracy
        self.signal = signal
        self.max_droplets = max_droplets
        self.tail_droplets = tail_droplets
        self.fog_preset = fog_preset
        self.show_progressbar = show_progressbar  # accepted for API parity
        self.device = resolve_device(device)

        # ice refractive index for the snow modes (Warren & Brandt 2008,
        # 905 nm); water otherwise
        m = complex(1.302, 2.9e-7) if mode in _SNOW_MODES else WATER_M_905NM
        self._lut = bake_mie_lut(wavelength_nm=wavelength, m=m)
        # fog droplets live at um scales, precipitation at mm scales
        if mode == "fog":
            d_lo, d_hi = min(min_diameter, 1e-3), 0.1
        else:
            d_lo, d_hi = min_diameter, 10.0
        self._d_grid = np.geomspace(d_lo, d_hi, dsd_points)   # mm
        self._qext = self._lut.interp_qext(self._d_grid)
        self._qback = self._lut.interp_qback(self._d_grid)
        # the geomspace grid is uniform in log(D): lookups are index
        # arithmetic
        self._log_d0 = math.log(d_lo)
        self._inv_dlog = (dsd_points - 1) / math.log(d_hi / d_lo)

    # ---- particle-size distributions ----

    def Nd(self, D, Rr):
        """Particle-size distribution [m^-3 mm^-1] at diameter D [mm] for
        precipitation rate Rr [mm/h] by mode: rain Marshall & Palmer 1948,
        snow 'gunn' Gunn & Marshall 1958, 'sekhon' Sekhon & Srivastava 1970,
        fog the Shettle & Fenn 1979 modified-gamma presets (Rr a density
        multiplier there). See the JAX module's docstring for the constants'
        sources."""
        D = np.asarray(D)
        if self.mode in ("snow", "gunn"):
            lam = 2.55 * Rr ** (-0.48)
            return 3800.0 * Rr ** (-0.87) * np.exp(-lam * D)
        if self.mode == "sekhon":
            lam = 2.29 * Rr ** (-0.45)
            return 2500.0 * Rr ** (-0.94) * np.exp(-lam * D)
        if self.mode == "fog":
            a, alpha, b = _FOG_PRESETS[self.fog_preset]
            rad_um = 500.0 * D
            return Rr * a * rad_um**alpha * np.exp(-b * rad_um) * 1e6 * 500.0
        lam = 4.1 * Rr ** (-0.21)
        return 8000.0 * np.exp(-lam * D)

    @property
    def D(self):
        """Diameter quadrature grid [mm]."""
        return self._d_grid

    def alpha(self, curve_or_Rr):
        """Extinction coefficient [1/m], from a rate Rr [mm/h] or a density
        curve N(D) on `self.D`."""
        nd = np.asarray(curve_or_Rr)
        if nd.ndim == 0:
            nd = self.Nd(self._d_grid, float(nd))
        integrand = self._qext * (np.pi / 4.0) * self._d_grid**2 * nd * 1e-6
        return float(np.trapezoid(integrand, self._d_grid))

    def droplet_density(self, Rr):
        """Total droplet number density [m^-3]."""
        nd = self.Nd(self._d_grid, Rr)
        return float(np.trapezoid(nd, self._d_grid))

    def _dsd_lambda(self, Rr):
        """Exponential-DSD rate [mm^-1] by mode; None for the fog presets."""
        if self.mode in ("snow", "gunn"):
            return 2.55 * Rr ** (-0.48)
        if self.mode == "sekhon":
            return 2.29 * Rr ** (-0.45)
        if self.mode == "fog":
            return None
        return 4.1 * Rr ** (-0.21)

    def _dsd_tables(self, Rr):
        """The sampling and lookup tables as f32 numpy (lisa.py:223-292,
        without the bf16 parts table): (lam, e_lo, e_span) of the analytic
        truncated-exponential inverse CDF (1, 0, 0 for fog); inv_pairs, the
        fog DSD's uniform-quantile inverse-CDF knot pairs ((1, 2) zeros
        otherwise); qb_pairs, the Qback knot pairs; cap_pairs, the knot
        pairs of cummax(Qback) and cummax(Qback * D^2)."""
        lam = self._dsd_lambda(Rr)
        if lam is None:
            nd = self.Nd(self._d_grid, Rr)
            cdf = np.concatenate([[0.0], np.cumsum(
                0.5 * (nd[1:] + nd[:-1]) * np.diff(self._d_grid)
            )])
            cdf /= cdf[-1]
            q = np.linspace(0.0, 1.0, 513)
            inv = np.interp(q, cdf, self._d_grid)
            inv_pairs = np.column_stack([inv[:-1], inv[1:]])
            lam, e_lo, e_span = 1.0, 0.0, 0.0
        else:
            d_lo, d_hi = float(self._d_grid[0]), float(self._d_grid[-1])
            e_lo = math.exp(-lam * d_lo)
            e_span = e_lo - math.exp(-lam * d_hi)
            inv_pairs = np.zeros((1, 2))
        qb = self._qback
        qmax = np.maximum.accumulate(qb)
        qd2 = np.maximum.accumulate(qb * self._d_grid**2)
        f32 = np.float32
        return (
            f32(lam), f32(e_lo), f32(e_span),
            np.asarray(inv_pairs, f32),
            np.asarray(np.column_stack([qb[:-1], qb[1:]]), f32),
            np.asarray(np.column_stack([qmax[:-1], qmax[1:], qd2[:-1],
                                        qd2[1:]]), f32),
        )

    def core_config(self) -> LisaCoreConfig:
        return LisaCoreConfig(
            mode=self.mode, log_d0=self._log_d0, inv_dlog=self._inv_dlog,
            gm1=self._d_grid.size - 1, beam_divergence=self.beam_divergence,
            r_min=self.r_min, r_max=self.r_max,
            range_accuracy=self.range_accuracy,
        )

    # ---- host API ----

    def augment(self, pc: np.ndarray, Rr: float = 10.0,
                fixed_seed: bool = False, seed: int = 0) -> np.ndarray:
        """Augment an (N, >=4) cloud at rate Rr [mm/h]: an (N, 6) array
        [x, y, z, intensity, label, intensity_diff], label 0 lost (point at
        the origin), 1 attenuated, 2 scattered. Intensities on [0, 255] are
        normalized inside and scaled back on output (the diff column stays
        normalized)."""
        res, scale_back = self._run(pc, Rr, fixed_seed, seed)
        out = res.points[: len(pc)].cpu().numpy().copy()
        out[:, 3] *= scale_back
        return out

    def augment_compact(self, pc: np.ndarray, Rr: float = 10.0,
                        fixed_seed: bool = False, seed: int = 0):
        """(kept points (M, 5), stats dict) with the lost points removed."""
        res, scale_back = self._run(pc, Rr, fixed_seed, seed)
        keep = res.keep.cpu().numpy()
        kept = res.points.cpu().numpy()[keep][:, :5].copy()
        kept[:, 3] *= scale_back
        stats = {
            "num_lost": int(res.num_lost),
            "num_scattered": int(res.num_scattered),
            "num_attenuated": int(res.num_attenuated),
            "droplet_overflow": int(res.droplet_overflow),
        }
        return kept, stats

    def _run(self, pc: np.ndarray, Rr: float, fixed_seed: bool, seed: int):
        pc = np.asarray(pc)
        n = pc.shape[0]
        cap = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
        pc5 = np.zeros((n, 5), np.float32)
        pc5[:, : min(pc.shape[1], 5)] = pc[:, :5]
        i_max = float(pc5[:, 3].max()) if n else 0.0
        scale_back = 255.0 if i_max > 1.5 else 1.0
        pc5[:, 3] /= scale_back
        padded = pad_cloud(pc5, cap)
        dev = self.device
        points = torch.as_tensor(padded.points, device=dev)
        mask = torch.as_tensor(padded.mask, device=dev)
        alpha = torch.tensor(self.alpha(Rr), dtype=torch.float32, device=dev)
        density = torch.tensor(self.droplet_density(Rr), dtype=torch.float32,
                               device=dev)
        tables = lisa_tables_to_torch(self._dsd_tables(Rr), dev)
        if not fixed_seed:
            seed = int(np.random.randint(2**31))
        # self-tuning capacity: when the residual bound says a non-sampled
        # droplet could have changed a point's outcome, double both
        # candidate sets, draw again at the grown shapes and rerun
        for _attempt in range(_ATTEMPTS):
            gen = torch.Generator(device=dev).manual_seed(seed)
            draws = lisa_draws(cap, self.max_droplets, self.tail_droplets,
                               gen)
            res = lisa_augment_core(points, mask, draws, alpha, density,
                                    tables, self.core_config())
            overflow = int(res.droplet_overflow)
            if overflow == 0:
                break
            self.max_droplets *= 2
            self.tail_droplets *= 2
            logger.warning(
                "LISA droplet capacity grew to (%d nearest, %d tail) after "
                "%d overflowing points",
                self.max_droplets, self.tail_droplets, overflow,
            )
        else:
            raise RuntimeError(
                f"LISA droplet overflow persisted: {overflow} points at "
                f"max_droplets={self.max_droplets}"
            )
        return res, scale_back
