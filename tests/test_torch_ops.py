"""The port's plain ops against the JAX package on the same numpy inputs.

Geometry, fitting, laser and fresnel functions of lidar_snow_sim_tpu_torch
hold against their JAX counterparts. Elementwise selects and sort-based
order statistics are exact; reductions, transcendentals and small solves
are compared at float32 tolerances (torch and XLA sum in other orders, and
XLA's CPU backend contracts a*b+c into fused multiply-adds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu import camera as jcam
from lidar_snow_sim_tpu.ops import fitting as jfit
from lidar_snow_sim_tpu.ops import fresnel as jfres
from lidar_snow_sim_tpu.ops import geometry as jgeo
from lidar_snow_sim_tpu.ops import laser as jlaser
from lidar_snow_sim_tpu_torch import synthetic_scan
from lidar_snow_sim_tpu_torch import camera as tcam
from lidar_snow_sim_tpu_torch.ops import fitting as tfit
from lidar_snow_sim_tpu_torch.ops import fresnel as tfres
from lidar_snow_sim_tpu_torch.ops import geometry as tgeo
from lidar_snow_sim_tpu_torch.ops import laser as tlaser


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are small: one intra-op thread per test worker keeps
    the workers from oversubscribing the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scan():
    pc = synthetic_scan(n_azimuth=100, seed=2)
    mask = np.ones(len(pc), bool)
    mask[::7] = False
    return pc, mask


def test_wrap_and_beam_limits(scan):
    pc, _ = scan
    a = np.random.default_rng(0).uniform(-6, 12, 4096).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jgeo.wrap_02pi(jnp.asarray(a))), tgeo.wrap_02pi(T(a))
    )
    beam = float(np.radians(np.degrees(3e-3)))
    jr, jl = jgeo.beam_limits(jnp.asarray(pc[:, 0]), jnp.asarray(pc[:, 1]),
                              beam)
    tr, tl = tgeo.beam_limits(T(pc[:, 0]), T(pc[:, 1]), beam)
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        tgeo.norm3(T(pc[:, :3])), np.linalg.norm(pc[:, :3], axis=1),
        rtol=1e-6,
    )


def test_masked_statistics(scan):
    pc, mask = scan
    x, y = pc[:, 0], pc[:, 3]
    jm, tm = jnp.asarray(mask), T(mask)
    np.testing.assert_allclose(
        tfit.masked_mean(T(x), tm),
        jax.jit(jfit.masked_mean)(jnp.asarray(x), jm), rtol=1e-6,
    )
    for j, t in zip(
        jax.jit(jfit.masked_linregress)(jnp.asarray(x), jnp.asarray(y), jm),
        tfit.masked_linregress(T(x), T(y), tm),
    ):
        np.testing.assert_allclose(t, j, rtol=1e-4)
    d = np.linalg.norm(pc[:, :3], axis=1).astype(np.float32)
    pj = jax.jit(jfit.masked_polyfit2)(jnp.asarray(d), jnp.asarray(y), jm)
    pt = tfit.masked_polyfit2(T(d), T(y), tm)
    np.testing.assert_allclose(
        tfit.polyval2(pt, T(d)), jfit.polyval2(pj, jnp.asarray(d)),
        rtol=1e-4, atol=1e-3,
    )
    # order statistics come from the same sorted values: exact
    z = pc[:, 2]
    assert float(tfit.masked_median(T(z), tm)) == float(
        jax.jit(jfit.masked_median)(jnp.asarray(z), jm)
    )
    for sub in (mask, mask & (z < -1.55), np.zeros_like(mask)):
        jmed, jmad = jax.jit(jfit.masked_median_and_mad)(
            jnp.asarray(z), jnp.asarray(sub)
        )
        tmed, tmad = tfit.masked_median_and_mad(T(z), T(sub))
        assert float(tmed) == float(jmed)
        assert float(tmad) == float(jmad)


def test_closed_form_solves():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(32, 3, 3)).astype(np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    sol_t, det_t = tfit._solve3(T(a), T(b))
    for i in range(32):
        sol_j, det_j = jfit._solve3(jnp.asarray(a[i]), jnp.asarray(b[i]))
        np.testing.assert_allclose(det_t[i], det_j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sol_t[i], sol_j, rtol=1e-4, atol=1e-5)
    a2, b2 = a[0, :2, :2], b[0, :2]
    np.testing.assert_allclose(
        tfit._solve2(T(a2), T(b2)),
        jfit._solve2(jnp.asarray(a2), jnp.asarray(b2)), rtol=1e-5,
    )


@pytest.mark.parametrize("key_seed", [0, 3])
def test_ransac_plane_same_draws(scan, key_seed):
    """Both packages pick the same trial points from the uniforms that
    jax.random draws at fitting.py:217."""
    pc, mask = scan
    key = jax.random.PRNGKey(key_seed)
    draws = np.asarray(jax.random.uniform(key, (64, 3)))
    wj, hj = jax.jit(jfit.ransac_plane)(jnp.asarray(pc[:, :3]),
                                        jnp.asarray(mask), key)
    wt, ht = tfit.ransac_plane(T(pc[:, :3]), T(mask), T(draws))
    assert np.asarray(wj)[2] != 1.0   # a real fit, not the fallback
    np.testing.assert_allclose(wt, np.asarray(wj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ht), float(hj), rtol=0, atol=1e-4)


def test_ransac_flat_earth_fallback(scan):
    pc, _ = scan
    empty = np.zeros(len(pc), bool)
    w, h = tfit.ransac_plane(T(pc[:, :3]), T(empty),
                             tfit.ransac_draws(0, 64))
    np.testing.assert_array_equal(w, [0.0, 0.0, 1.0])
    assert float(h) == float(np.float32(-1.55))


def test_laser_parameters(scan):
    pc, mask = scan
    xyz = pc[:, :3]
    inc = np.random.default_rng(2).uniform(0.1, 1.2, len(pc)).astype(
        np.float32
    )
    d = np.linalg.norm(xyz, axis=1).astype(np.float32)
    norm_int = (pc[:, 3] / np.cos(inc)).astype(np.float32)
    xj, mj, rj = jax.jit(jlaser.noise_floor_rows)(jnp.asarray(d),
                                         jnp.asarray(norm_int),
                                         jnp.asarray(mask))
    xt, mt, rt = tlaser.noise_floor_rows(T(d), T(norm_int), T(mask))
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-6)
    np.testing.assert_allclose(mt, np.asarray(mj), rtol=1e-6)
    np.testing.assert_array_equal(rt, np.asarray(rj))
    for method in ("linear", "poly"):
        oj, tj = jax.jit(
            jlaser.estimate_laser_parameters,
            static_argnames=("estimation_method",),
        )(
            jnp.asarray(xyz), jnp.asarray(pc[:, 3]), jnp.asarray(inc),
            jnp.asarray(mask), estimation_method=method,
        )
        ot, tt = tlaser.estimate_laser_parameters(
            T(xyz), T(pc[:, 3]), T(inc), T(mask), estimation_method=method,
        )
        np.testing.assert_allclose(ot, np.asarray(oj), rtol=2e-4, atol=1e-2)
        np.testing.assert_allclose(tt, np.asarray(tj), rtol=2e-4, atol=1e-2)


def test_camera_fov_mask():
    """The FOV filter of api.augment and the precompute CLI: the same mask
    on a 360-degree scan, with the default rig and with one read from a
    calibration file."""
    pc = synthetic_scan(n_azimuth=200, fov_deg=360.0, seed=4)
    path = jcam.DEFAULT_CALIB_FILE
    for jc, tc in ((None, None), (jcam.CameraCalibration.from_file(path),
                                  tcam.CameraCalibration.from_file(path))):
        want = np.asarray(jcam.camera_fov_mask(jnp.asarray(pc[:, :3]), jc))
        got = tcam.camera_fov_mask(pc[:, :3], tc).numpy()
        assert 0 < want.sum() < len(pc)
        np.testing.assert_array_equal(got, want)


def test_fresnel_transmittance():
    ain = np.linspace(0.01, 1.5, 512).astype(np.float32)
    rho = np.linspace(0.05, 1.0, 512).astype(np.float32)
    for j, t in zip(
        jfres.total_transmittance_from_ground(jnp.asarray(ain),
                                              rho=jnp.asarray(rho)),
        tfres.total_transmittance_from_ground(T(ain), rho=T(rho)),
    ):
        np.testing.assert_allclose(t, np.asarray(j), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(
        tfres.bathymetric_scattering(T(ain)),
        np.asarray(jfres.bathymetric_scattering(jnp.asarray(ain))),
        rtol=2e-5,
    )
    np.testing.assert_allclose(
        tfres.lidar_measurement(T(ain * 50)),
        np.asarray(jfres.lidar_measurement(jnp.asarray(ain * 50))),
        rtol=2e-5,
    )
