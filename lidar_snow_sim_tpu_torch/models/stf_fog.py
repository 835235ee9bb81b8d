"""STF-style foggification on tensors (counterpart of
`lidar_snow_sim_tpu/models/stf_fog.py`, the SeeingThroughFog devkit's
``BetaRadomization`` / ``haze_point_cloud`` surface).

The extinction coefficient is randomized over azimuth by a smooth harmonic
field (`BetaRandomization`, seeded numpy on the host, copied from the JAX
module because it imports jax). Per point, a return that the attenuation
leaves undetectable is, with probability `fraction_random`, replaced by a
near-sensor clutter return (label 2), otherwise dropped; detectable points
keep their geometry with the attenuated intensity (label 0).
`haze_point_cloud_padded` takes its three uniform draws injected.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_snow_sim_tpu_torch.device import resolve_device
from lidar_snow_sim_tpu_torch.utils.pointcloud import pad_cloud
from lidar_snow_sim_tpu_torch.ops.geometry import norm3


class BetaRandomization:
    """Azimuth-dependent extinction field
    beta(phi) = beta * max(1 + sum_k a_k sin(k phi + psi_k), 0.05), with
    amplitudes decaying as 1/k^2. Seeded on the host."""

    def __init__(self, beta: float, seed: int = 0, n_harmonics: int = 8,
                 strength: float = 0.3):
        self.beta = float(beta)
        self.seed = seed
        rng = np.random.default_rng(seed)
        k = np.arange(1, n_harmonics + 1)
        self.amps = (strength * rng.uniform(0, 1, n_harmonics) / k**2).astype(
            np.float32
        )
        self.phases = rng.uniform(0, 2 * np.pi, n_harmonics).astype(np.float32)
        self.ks = k.astype(np.float32)

    def coefficients(self, device="cpu"):
        """(amps, phases, ks, beta) as f32 tensors on `device`."""
        return (
            torch.as_tensor(self.amps, device=device),
            torch.as_tensor(self.phases, device=device),
            torch.as_tensor(self.ks, device=device),
            torch.tensor(self.beta, dtype=torch.float32, device=device),
        )

    def get_beta(self, azimuth):
        """beta at azimuth (radians), vectorized over a tensor or array."""
        az = torch.as_tensor(azimuth, dtype=torch.float32)
        amps, phases, ks, beta = self.coefficients(az.device)
        return _beta_field(az, amps, phases, ks, beta)

    def propagate_in_time(self, steps: int):
        """Advect the field as the viewer does before foggification
        (``B.propagate_in_time(10)``): each step drifts every harmonic's
        phase by a seeded per-harmonic velocity."""
        rng = np.random.default_rng([self.seed, 0x9E3779B9])
        velocity = rng.uniform(-0.1, 0.1, self.ks.shape[0]).astype(np.float32)
        self.phases = (
            (self.phases + steps * velocity * self.ks) % (2 * np.pi)
        ).astype(np.float32)
        return self


# the reference's (misspelled) class name
BetaRadomization = BetaRandomization


def _beta_field(azimuth, amps, phases, ks, beta):
    mod = 1.0 + (amps * torch.sin(ks * azimuth[..., None] + phases)).sum(-1)
    return beta * torch.clamp(mod, min=0.05)


class StfFogResult(NamedTuple):
    points: torch.Tensor      # (N, 5), label col: 0 kept, 2 clutter
    keep: torch.Tensor
    num_scattered: torch.Tensor
    num_attenuated: torch.Tensor
    num_removed: torch.Tensor


def stf_draws(n: int, generator: torch.Generator):
    """The three U[0, 1) streams of `haze_point_cloud_padded`, each (n,), on
    the generator's device: clutter choice, clutter range, clutter
    intensity."""
    dev = generator.device
    return tuple(torch.rand((n,), generator=generator, device=dev)
                 for _ in range(3))


def haze_point_cloud_padded(points, mask, beta_coeffs, draws, *,
                            gain: float = 20.0, noise: float = 10.0,
                            fraction_random: float = 0.05,
                            clutter_min_range: float = 1.3) -> StfFogResult:
    """STF foggification of a padded (N, 5) scan (stf_fog.py:92-147): a
    point is detectable iff i * exp(-2 beta d) * gain > noise; an
    undetectable one becomes, with probability fraction_random, a clutter
    return at range U(clutter_min_range, d) with a sub-noise intensity."""
    amps, phases, ks, beta0 = beta_coeffs
    u_choice, u_range, u_int = draws
    xyz = points[:, :3]
    intensity = points[:, 3]
    d = torch.clamp(norm3(xyz), min=1e-6)
    azimuth = torch.atan2(xyz[:, 1], xyz[:, 0])
    beta = _beta_field(azimuth, amps, phases, ks, beta0)

    i_att = intensity * torch.exp(-2.0 * beta * d)
    detectable = i_att * gain > noise
    make_clutter = (u_choice < fraction_random) & ~detectable
    r_new = clutter_min_range + u_range * torch.clamp(
        d - clutter_min_range, min=0.0)
    i_clutter = u_int * noise

    scale = torch.where(make_clutter, r_new / d, 1.0)
    new_xyz = xyz * scale[:, None]
    new_i = torch.where(make_clutter, i_clutter, i_att)
    label = torch.where(make_clutter, 2.0, 0.0)
    keep = mask & (detectable | make_clutter)
    out = torch.cat([new_xyz, new_i[:, None], label[:, None]], dim=1)
    i32 = torch.int32
    return StfFogResult(
        points=out,
        keep=keep,
        num_scattered=(keep & make_clutter).sum().to(i32),
        num_attenuated=(keep & detectable).sum().to(i32),
        num_removed=(mask & ~keep).sum().to(i32),
    )


def haze_point_cloud(pc, randomized_beta, arguments=None, seed: int = 0,
                     device="cuda"):
    """The reference call contract (``pc = haze_point_cloud(pc, B,
    arguments)`` after ``B = BetaRadomization(beta, seed=0)``): an (M, >=5)
    array whose columns start [x, y, z, intensity, label]. Of the devkit
    arguments only ``fraction_random`` is read."""
    pc = np.asarray(pc)
    fraction_random = getattr(arguments, "fraction_random", 0.05)
    aug, _ = StfFogAugmenter(
        beta=randomized_beta.beta, seed=seed,
        fraction_random=fraction_random,
        _randomization=randomized_beta, device=device,
    )(pc)
    if pc.shape[1] > aug.shape[1]:
        extra = np.zeros((len(aug), pc.shape[1] - aug.shape[1]), aug.dtype)
        aug = np.concatenate([aug, extra], axis=1)
    return aug


class StfFogAugmenter:
    """Host wrapper of ``haze_point_cloud(pc, BetaRadomization)``; keyword
    arguments go to `haze_point_cloud_padded`. The draws come from a
    generator on `device` seeded `seed`."""

    def __init__(self, beta: float = 0.05, seed: int = 0,
                 _randomization=None, device: str | torch.device = "cuda",
                 **kwargs):
        self.randomization = _randomization or BetaRandomization(
            beta, seed=seed
        )
        self.kwargs = kwargs
        self.seed = seed
        self.device = resolve_device(device)

    def run(self, pc: np.ndarray) -> StfFogResult:
        n = pc.shape[0]
        cap = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
        padded = pad_cloud(np.asarray(pc), cap)
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        return haze_point_cloud_padded(
            torch.as_tensor(padded.points, device=dev),
            torch.as_tensor(padded.mask, device=dev),
            self.randomization.coefficients(dev),
            stf_draws(cap, gen),
            **self.kwargs,
        )

    def __call__(self, pc: np.ndarray):
        res = self.run(pc)
        stats = {
            "num_scattered": int(res.num_scattered),
            "num_attenuated": int(res.num_attenuated),
            "num_removed": int(res.num_removed),
        }
        return res.points[res.keep].cpu().numpy(), stats
