"""The benchmark's frozen input generators and reference against the
port's generators and NumPy oracle, at a small size: bit for bit where
the reference copies the oracle, to float32 rounding where it restates
the port's float32 RANSAC and noise floor in float64."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu_torch.calib import load_hdl64_calib
from lidar_snow_sim_tpu_torch.oracle import snowfall as port_oracle
from lidar_snow_sim_tpu_torch.parallel.batched import frame_draws
from lidar_snow_sim_tpu_torch.config import SnowfallConfig
from lidar_snow_sim_tpu_torch.models.snowfall import _plane_and_noise
from lidar_snow_sim_tpu_torch.ops.fitting import ransac_draws, ransac_plane
from lidar_snow_sim_tpu_torch.sampling import distributions
from lidar_snow_sim_tpu_torch.sampling.dart import dart_throwing_fast
from lidar_snow_sim_tpu_torch.utils.synthetic import synthetic_scan

from port_bench import compare, inputs
from port_bench.reference import bfloat16, reference_frame
from port_bench.reference.fitting import noise_at
from port_bench.reference.fitting import ransac_plane as ref_plane
from port_bench.reference.oracle import occlusion_dicts

BEAM_DEG = float(np.degrees(3e-3))
CALIB = inputs.load_calib()


def _sets(seed=11, n=64, count=300):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ang = rng.uniform(0, 2 * np.pi, count)
        d = np.sqrt(rng.uniform(0.01, 1, count)) * 40
        r = rng.uniform(0.005, 0.05, count)
        out.append(np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))
    return out


def test_calibration_equals_the_ports():
    port = load_hdl64_calib()
    for f in ("min_intensity", "focal_distance", "focal_slope",
              "focal_offset", "max_intensity", "vert_correction"):
        np.testing.assert_array_equal(getattr(CALIB, f), getattr(port, f))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 40 + 7])
def test_synthetic_scan_equals_the_ports(seed):
    np.testing.assert_array_equal(
        inputs.synthetic_scan(CALIB, n_azimuth=120, seed=seed),
        synthetic_scan(n_azimuth=120, seed=seed))


@pytest.mark.parametrize("mode,rate,velocity", [("gunn", 2.5, 1.6),
                                                ("sekhon", 0.5, 2.0)])
def test_dart_throwing_equals_the_ports(mode, rate, velocity):
    rr = inputs.rainfall_rate(rate, velocity)
    occ = inputs.occupancy(rate, velocity)
    assert rr == distributions.snowfall_rate_to_rainfall_rate(rate, velocity)
    assert occ == distributions.compute_occupancy(rate, velocity)
    np.testing.assert_array_equal(
        inputs.dart_throwing_fast(occ, rr, 10.0, np.random.default_rng(5),
                                  mode, batch=4096),
        dart_throwing_fast(occ, rr, 10.0, np.random.default_rng(5), mode,
                           batch=4096))


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_ransac_draws_equal_the_ports(seed):
    np.testing.assert_array_equal(inputs.ransac_draws(seed, 64),
                                  ransac_draws(seed, 64).numpy())
    snow, _ = frame_draws(seed, SnowfallConfig(), None)
    np.testing.assert_array_equal(inputs.ransac_draws(seed, 64),
                                  snow.numpy())


def test_frame_pool_is_a_function_of_the_seed():
    scan = {"pool": 3, "n_azimuth": 40, "fov_deg": 87.0}
    a = inputs.frame_pool(2 ** 33 + 1, scan, CALIB)
    b = inputs.frame_pool(2 ** 33 + 1, scan, CALIB)
    c = inputs.frame_pool(2 ** 33 + 2, scan, CALIB)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.scan, y.scan)
        np.testing.assert_array_equal(x.order, y.order)
        assert x.ransac_seed == y.ransac_seed < 2 ** 31
    assert not np.array_equal(a[0].scan, c[0].scan)


@pytest.mark.parametrize("channel", [0, 20, 63])
def test_occlusion_dicts_equal_the_ports_oracle(channel):
    pc = synthetic_scan(n_azimuth=300, seed=4)
    cpc = pc[pc[:, 4] == channel].astype(np.float64)
    d = np.linalg.norm(cpc[:, :3], axis=1)
    br = np.radians(BEAM_DEG)
    center = port_oracle._wrap_02pi(np.arctan2(cpc[:, 1], cpc[:, 0]))
    beams = port_oracle._wrap_02pi(np.column_stack([center - br / 2,
                                                    center + br / 2]))
    sets = _sets(count=2000, seed=channel)[0]
    # a particle astride the 0/2pi seam and one wide enough to be a
    # candidate of every beam
    sets = np.vstack([sets, [[5.0, -0.001, 0.01], [0.3, 0.1, 0.04]]])
    assert (occlusion_dicts(beams, d, sets, BEAM_DEG)
            == port_oracle.occlusion_dicts(beams, d, sets, BEAM_DEG))


def test_reference_frame_equals_the_ports_oracle():
    pc = synthetic_scan(n_azimuth=80, seed=2)
    sets = _sets()
    order = np.random.default_rng(3).permutation(64)
    draws = inputs.ransac_draws(9, 64)
    ref = reference_frame(pc, sets, CALIB, order, draws,
                          beam_divergence_deg=BEAM_DEG, noise_floor=0.7,
                          fit_on_sorted=True)
    plane = ref_plane(pc[np.argsort(pc[:, 4], kind="stable")][:, :3]
                      .astype(np.float64), draws)
    stats, aug = port_oracle.augment(pc.astype(np.float64), sets,
                                     load_hdl64_calib(), order, BEAM_DEG,
                                     plane=plane, device_semantics=True)
    assert ref["stats"] == stats
    np.testing.assert_array_equal(ref["rows"][ref["keep"]], aug)
    # spread over processes, the same result
    par = compare.reference_results([(pc, order, draws)], sets, CALIB,
                                    beam_divergence_deg=BEAM_DEG,
                                    noise_floor=0.7, fit_on_sorted=True,
                                    workers=2)[0]
    assert par["stats"] == ref["stats"]
    np.testing.assert_array_equal(par["rows"], ref["rows"])


@pytest.mark.parametrize("seed", [1, 6])
def test_plane_and_noise_floor_agree_with_the_ports_float32(seed):
    pc = synthetic_scan(n_azimuth=300, seed=seed)
    draws = inputs.ransac_draws(seed, 64)
    xyz = pc[:, :3].astype(np.float64)
    w, h = ref_plane(xyz, draws)
    mask = torch.ones(len(pc), dtype=torch.bool)
    tw, th = ransac_plane(torch.from_numpy(pc[:, :3]), mask,
                          torch.from_numpy(draws))
    np.testing.assert_allclose(w, tw.numpy(), atol=1e-5)
    assert abs(h - float(th)) < 1e-4
    t_noise = _plane_and_noise(
        torch.from_numpy(pc[:, :3]), torch.from_numpy(pc[:, 3]), mask,
        torch.linalg.vector_norm(torch.from_numpy(pc[:, :3]), dim=1),
        torch.from_numpy(draws), SnowfallConfig(), None)
    np.testing.assert_allclose(noise_at(xyz, pc[:, 3], (w, h)),
                               t_noise.numpy(), atol=2e-2)


def test_bfloat16_rounds_to_eight_significant_bits():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.14159265, -2.5e-3, 0.0])
    np.testing.assert_array_equal(
        bfloat16(x), torch.tensor(x, dtype=torch.float32)
        .to(torch.bfloat16).double().numpy())
