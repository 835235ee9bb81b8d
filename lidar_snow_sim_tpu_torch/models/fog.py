"""Fog simulation on tensors (counterpart of
`lidar_snow_sim_tpu/models/fog.py`, the ICCV'21 LiDAR_fog_sim surface).

Per point with intensity i at range r0: the hard channel attenuates two-way,
i * exp(-2 alpha r0); the soft channel is the fog volume's back-scattered
pulse, precomputed once on the quantized range grid (`soft_response_curve`)
and read at its running maximum over the ranges before the target. A point
whose soft response beats its hard one becomes a fog return at the running
argmax's range plus range noise (label 2); the rest keep their geometry
with the attenuated intensity (label 0). No point is removed.

The parameter classes are host dataclasses, copied from the JAX module
because it imports jax. `fog_augment` takes its random draws injected.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.config import SPEED_OF_LIGHT
from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.utils.pointcloud import pad_cloud
from lidar_snow_sim_tpu_torch.ops.f32 import div
from lidar_snow_sim_tpu_torch.ops.geometry import norm3


@dataclasses.dataclass(frozen=True)
class FogParameterSet:
    """Fog + sensor parameters. alpha: extinction coefficient [1/m]; MOR and
    beta derive from it unless beta is given; beta_0 derives from gamma
    unless given."""

    alpha: float = 0.06
    beta: float | None = None
    # differential reflectivity calibration (viewer: gamma=1e-6 and
    # beta_0 = gamma/pi)
    gamma: float = 1e-6
    beta_0: float | None = None
    # sensor model (HDL-64E-like, the snowfall engine's constants)
    tau_h: float = 1e-8          # pulse width [s]
    lidar_range: float = 120.0
    intervals_per_meter: int = 10
    xsi_r1: float = 0.9          # receiver overlap ramp
    xsi_r2: float = 1.0
    # measurement noise on the fog-return range (see fog_augment)
    noise: float = 10.0
    noise_variant: str = "v4"

    @property
    def mor(self) -> float:
        """Meteorological optical range [m]."""
        return math.log(20.0) / self.alpha

    @property
    def beta_eff(self) -> float:
        return self.beta if self.beta is not None else 0.046 / self.mor

    @property
    def beta_0_eff(self) -> float:
        return self.beta_0 if self.beta_0 is not None else self.gamma / math.pi

    @property
    def num_bins(self) -> int:
        m = self.lidar_range * self.intervals_per_meter
        return int(
            np.ceil(m + SPEED_OF_LIGHT * self.tau_h * self.intervals_per_meter)
        )


class ParameterSet:
    """Mutable kwargs-style parameter bag of the submodule's ``ParameterSet``
    construction pattern: any keyword becomes an attribute, and the derived
    attributes (mor, beta, beta_0) may be overwritten after construction."""

    def __init__(self, **kwargs):
        self.alpha = 0.06
        self.alpha_min = 0.003
        self.alpha_max = 0.5
        self.alpha_scale = 1000
        self.gamma = 1e-6
        self.gamma_min = 1e-7
        self.gamma_max = 1e-5
        self.gamma_scale = 1e7
        self.mor = math.log(20.0) / self.alpha
        self.beta = 0.046 / self.mor
        self.beta_0 = self.gamma / math.pi
        self.tau_h = 1e-8
        self.lidar_range = 120.0
        self.intervals_per_meter = 10
        self.xsi_r1 = 0.9
        self.xsi_r2 = 1.0
        for k, v in kwargs.items():
            setattr(self, k, v)
        # re-derive when alpha/gamma came in via kwargs without overrides
        if "alpha" in kwargs and "mor" not in kwargs:
            self.mor = math.log(20.0) / self.alpha
        if "alpha" in kwargs and "beta" not in kwargs:
            self.beta = 0.046 / self.mor
        if "gamma" in kwargs and "beta_0" not in kwargs:
            self.beta_0 = self.gamma / math.pi

    def frozen(self, noise: float = 10.0,
               noise_variant: str = "v4") -> FogParameterSet:
        return FogParameterSet(
            alpha=self.alpha, beta=self.beta, gamma=self.gamma,
            beta_0=self.beta_0, tau_h=self.tau_h,
            lidar_range=self.lidar_range,
            intervals_per_meter=self.intervals_per_meter,
            xsi_r1=self.xsi_r1, xsi_r2=self.xsi_r2,
            noise=noise, noise_variant=noise_variant,
        )


class FogResult(NamedTuple):
    points: torch.Tensor      # (N, 5) augmented; label col: 0 kept, 2 fog
    keep: torch.Tensor        # (N,) valid input points (none removed)
    num_scattered: torch.Tensor
    num_attenuated: torch.Tensor
    num_removed: torch.Tensor
    min_fog_response: torch.Tensor   # over replaced points (NaN if none)
    max_fog_response: torch.Tensor
    soft_response: torch.Tensor  # (bins,) shared fog response curve


def _xsi(r, r1: float, r2: float):
    return torch.clamp(div(r - r1, r2 - r1), 0.0, 1.0)


def soft_response_curve(p: FogParameterSet, device="cpu"):
    """Fog soft-channel response on the quantized range grid: (grid ranges,
    beta * C(R)), C the pulse-convolution integral."""
    ipm = p.intervals_per_meter
    c_tau = SPEED_OF_LIGHT * p.tau_h
    bins = p.num_bins
    r_grid = div(torch.arange(bins, dtype=torch.float32, device=device), ipm)
    taps = int(np.floor(c_tau * ipm)) + 1   # pulse support in bins

    # integrate the pulse over its support ending at each grid range
    dr = 1.0 / ipm
    offsets = div(torch.arange(taps, dtype=torch.float32, device=device), ipm)
    r = r_grid[:, None] - offsets[None, :]                      # (bins, T)
    valid = r > 1e-3
    rs = torch.where(valid, r, 1.0)
    pulse = torch.sin(div(math.pi * (r_grid[:, None] - rs), c_tau)) ** 2
    integrand = (pulse * _xsi(rs, p.xsi_r1, p.xsi_r2)
                 * torch.exp(-2.0 * p.alpha * rs) / rs ** 2)
    resp = torch.where(valid, integrand, 0.0).sum(dim=1) * dr
    return r_grid, p.beta_eff * resp


def running_max(soft):
    """Running max and argmax of a 1-D curve as fog.py's scan computes them
    (:206-218): from -1.0, a bin is taken only when strictly greater, so
    the FIRST bin of a tie wins (torch.cummax alone would report the
    last)."""
    pmax = torch.cummax(torch.clamp(soft, min=-1.0), dim=0).values
    prev = torch.cat([soft.new_full((1,), -1.0), pmax[:-1]])
    bins = torch.arange(soft.shape[0], device=soft.device)
    return pmax, torch.cummax(torch.where(soft > prev, bins, 0), dim=0).values


def fog_draws(n: int, generator: torch.Generator):
    """fog_augment's two streams on the generator's device: U[-1, 1) and
    standard normal, each (n,)."""
    dev = generator.device
    u = torch.rand((n,), generator=generator, device=dev) * 2.0 - 1.0
    g = torch.randn((n,), generator=generator, device=dev)
    return u, g


def fog_augment(p: FogParameterSet, points, mask, draws) -> FogResult:
    """Fog augmentation of a padded (N, 5) scan (fog.py:191-287): per-point
    hard vs soft channel competition, the label column rewritten, the
    info-dict counters. `draws` = (u, g) from `fog_draws`."""
    u, g = draws
    xyz = points[:, :3]
    intensity = points[:, 3]
    d = norm3(xyz)
    d_safe = torch.clamp(d, min=1e-6)
    ipm = p.intervals_per_meter

    _, soft = soft_response_curve(p, points.device)
    pmax, pargmax = running_max(soft)
    idx = torch.clamp((d_safe * ipm).to(torch.int32), 0,
                      soft.shape[0] - 1).long()
    p_soft = pmax[idx]
    r_fog = div(pargmax[idx].to(torch.float32), ipm)

    # hard response in the same power units, the target's reflectivity from
    # its intensity through the gamma calibration (gamma = 1e-6 maps i = 255
    # to a Lambertian target)
    gamma_rel = p.gamma / 1e-6
    beta_0_i = div(div(intensity, 255.0) * gamma_rel, math.pi)
    p_hard = (beta_0_i * _xsi(d_safe, p.xsi_r1, p.xsi_r2)
              * torch.exp(-2.0 * p.alpha * d_safe) / d_safe ** 2)
    fogged = mask & (p_soft > p_hard) & (d > 1e-3)

    # range noise: v1/v2 absolute (uniform/gaussian) at `noise` tenth-bins,
    # v3/v4 the same scaled by r_fog / MOR
    amp = p.noise / ipm
    rel = div(r_fog, p.mor)
    noise_r = {
        "v1": lambda: amp * u,
        "v2": lambda: amp * g,
        "v3": lambda: amp * u * rel,
        "v4": lambda: amp * g * rel,
    }[p.noise_variant]()
    r_new = torch.clamp(r_fog + noise_r, 0.3, p.lidar_range)

    scale = torch.where(fogged, r_new / d_safe, 1.0)
    new_xyz = xyz * scale[:, None]
    # fog-return counts: the soft power through the inverse calibration at
    # the return's apparent range
    i_fog = torch.clamp(
        255.0 * math.pi * p_soft * r_new ** 2
        / (gamma_rel * torch.clamp(_xsi(r_new, p.xsi_r1, p.xsi_r2), min=0.05)),
        0.0, 255.0,
    )
    i_att = intensity * torch.exp(-2.0 * p.alpha * d_safe)
    new_i = torch.where(fogged, i_fog, i_att)

    label = torch.where(fogged, 2.0, 0.0)
    out = torch.cat([new_xyz, new_i[:, None], label[:, None]], dim=1)
    any_fog = fogged.any()
    nan = torch.full((), math.nan, device=points.device)
    i32 = torch.int32
    return FogResult(
        points=out,
        keep=mask,
        num_scattered=fogged.sum().to(i32),
        num_attenuated=(mask & ~fogged & (new_i < intensity)).sum().to(i32),
        num_removed=torch.zeros((), dtype=i32, device=points.device),
        min_fog_response=torch.where(
            any_fog, torch.where(fogged, p_soft, math.inf).amin(), nan),
        max_fog_response=torch.where(
            any_fog, torch.where(fogged, p_soft, -math.inf).amax(), nan),
        soft_response=soft,
    )


class FogAugmenter:
    """Host wrapper; returns (augmented cloud, stats dict). The draws come
    from a generator on `device` seeded `seed`."""

    def __init__(self, params: FogParameterSet | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.params = params or FogParameterSet()
        self.seed = seed
        self.device = resolve_device(device)

    def run(self, pc: np.ndarray) -> FogResult:
        n = pc.shape[0]
        cap = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
        padded = pad_cloud(np.asarray(pc), cap)
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        return fog_augment(
            self.params,
            torch.as_tensor(padded.points, device=dev),
            torch.as_tensor(padded.mask, device=dev),
            fog_draws(cap, gen),
        )

    def __call__(self, pc: np.ndarray):
        res = self.run(pc)
        stats = {
            "num_scattered": int(res.num_scattered),
            "num_attenuated": int(res.num_attenuated),
            "num_removed": int(res.num_removed),
        }
        return res.points[res.keep].cpu().numpy(), stats


def simulate_fog(p, pc: np.ndarray, noise: float, gain: bool = False,
                 noise_variant: str = "v1", seed: int = 0, device="cuda"):
    """The reference call contract ``pc, simulated_fog_pc, info_dict =
    simulate_fog(p, pc, noise, gain, noise_variant)``; p is a ParameterSet
    or FogParameterSet. info_dict keys: min_fog_response, max_fog_response,
    num_fog_responses."""
    if isinstance(p, ParameterSet):
        fp = p.frozen(noise=noise, noise_variant=noise_variant)
    else:
        fp = dataclasses.replace(p, noise=noise, noise_variant=noise_variant)
    res = FogAugmenter(fp, seed=seed, device=device).run(np.asarray(pc))
    aug = res.points[res.keep].cpu().numpy()
    num = int(res.num_scattered)
    if gain and len(aug):
        peak = float(aug[:, 3].max())
        if peak > 0:
            aug[:, 3] *= 255.0 / peak
    fog_pc = aug[aug[:, 4] == 2.0]
    info = {
        "min_fog_response": float(res.min_fog_response) if num else np.inf,
        "max_fog_response": float(res.max_fog_response) if num else 0.0,
        "num_fog_responses": num,
    }
    return aug, fog_pc, info


def simulate_fog_pc(p: FogParameterSet, pc: np.ndarray, noise: float = 10.0,
                    seed: int = 0, device="cuda"):
    """`simulate_fog` returning stats-dict style info."""
    fp = dataclasses.replace(p, noise=noise)
    res = FogAugmenter(fp, seed=seed, device=device).run(np.asarray(pc))
    aug = res.points[res.keep].cpu().numpy()
    stats = {
        "num_scattered": int(res.num_scattered),
        "num_attenuated": int(res.num_attenuated),
        "num_removed": int(res.num_removed),
    }
    return aug, aug[aug[:, 4] == 2.0], stats
