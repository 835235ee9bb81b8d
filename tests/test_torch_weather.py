"""The port's weather baselines (LISA, fog, STF fog, DROR) against the JAX
package on identical inputs and identical random draws.

Each JAX function draws from a `jax.random` key; the test makes the same
draws from that key (the streams and splits of the JAX code) and hands them
to the port's function, whose draws are injected.

Tolerances:
- LISA, fog, STF fog: labels and keep equal on >= 99.8% of points (the
  boundary contract of tests/test_snowfall_parity.py); where they agree,
  points within rtol 1e-5, atol 1e-6 (metres, and intensity on LISA's
  [0, 1] scale; 1e-4 on the fog's [0, 255] counts). XLA's CPU backend
  contracts multiply-adds into FMAs, so the last bits differ. Capacity
  counters equal; outcome counters differ by no more than the flipped
  points.
- DROR: keep masks equal except on points with a pair within 1e-3 m of the
  radius boundary (the f32 expansion's cancellation, models/dror.py); on
  the boundary-safe clouds of test_weather_baselines.py, exactly. Window
  overflow counts equal.
"""

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.models import dror as jdror
from lidar_snow_sim_tpu.models import fog as jfog
from lidar_snow_sim_tpu.models import stf_fog as jstf
from lidar_snow_sim_tpu.models.lisa import LISA as JaxLISA
from lidar_snow_sim_tpu_torch import pad_cloud
from lidar_snow_sim_tpu_torch.models import dror, fog, stf_fog
from lidar_snow_sim_tpu_torch.models.lisa import (
    LISA,
    lisa_augment_core,
    lisa_tables_to_torch,
)
from test_weather_baselines import _boundary_safe_cloud, _dror_numpy_counts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    """test_weather_baselines.py's cloud: 3000 points at 3-80 m, intensity
    20-200."""
    rng = np.random.default_rng(3)
    n = 3000
    ang = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(3, 80, n)
    return np.column_stack([
        r * np.cos(ang), r * np.sin(ang), rng.uniform(-1.8, 1.0, n),
        rng.uniform(20, 200, n), rng.integers(0, 64, n),
    ]).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_parity(jp, tp, jkeep, tkeep, label_col, atol=1e-6):
    """Labels and keep equal on >= 99.8% of points, the rest within
    tolerance; returns the number of flipped points."""
    jp, tp = np.asarray(jp), tp.cpu().numpy()
    jkeep, tkeep = np.asarray(jkeep), tkeep.cpu().numpy()
    flip = (jp[:, label_col] != tp[:, label_col]) | (jkeep != tkeep)
    assert flip.mean() < 0.002, flip.sum()
    np.testing.assert_allclose(tp[~flip], jp[~flip], rtol=1e-5, atol=atol)
    return int(flip.sum())


# ---------------- LISA ----------------


def _lisa_draws(key, n, k1, k2):
    """The five streams of `LISA._augment_core` (lisa.py:348-380), in the
    port's order: exp (n, k1), exp (n, k2), uniform (n, k1), uniform
    (n, k2), normal (n,)."""
    kc, kt, kp, kd, kj = jax.random.split(key, 5)
    return tuple(_t(a) for a in (
        jax.random.exponential(kc, (n, k1)),
        jax.random.exponential(kt, (n, k2)),
        jax.random.uniform(kd, (n, k1)),
        jax.random.uniform(kp, (n, k2)),
        jax.random.normal(kj, (n,)),
    ))


@pytest.mark.parametrize("mode", ["rain", "gunn", "sekhon", "fog"])
def test_lisa_tables_equal_jax_bitwise(mode):
    rr = 1.0 if mode == "fog" else 10.0
    want = lisa_tables_to_torch(
        [np.asarray(t) for t in JaxLISA(mode=mode, dsd_points=64)
         ._dsd_tables(rr)], "cpu")
    got = lisa_tables_to_torch(LISA(mode=mode, dsd_points=64, device="cpu")
                               ._dsd_tables(rr), "cpu")
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("dsd_points,mxu_lookup",
                         [(64, False), (64, True), (256, False)])
@pytest.mark.parametrize("mode", ["rain", "gunn", "sekhon", "fog"])
def test_lisa_core_matches_jax(cloud, mode, dsd_points, mxu_lookup):
    """lisa_augment_core fed the JAX draws against LISA._augment_core, with
    the JAX kernel (interpret mode) and with its XLA gather as two
    references for the port's one lookup route, and on a 255-cell table,
    wider than the JAX kernel takes."""
    rr = 1.0 if mode == "fog" else 10.0
    jl = JaxLISA(mode=mode, dsd_points=dsd_points, mxu_lookup=mxu_lookup)
    tl = LISA(mode=mode, dsd_points=dsd_points, device="cpu")
    pc = cloud.copy()
    pc[:, 3] /= 255.0
    pad = pad_cloud(pc, 4096)
    key = jax.random.PRNGKey(7)
    tables = jl._dsd_tables(rr)
    alpha, dens = jl.alpha(rr), jl.droplet_density(rr)
    want = jax.device_get(jax.jit(jl._augment_core)(
        jnp.asarray(pad.points), jnp.asarray(pad.mask), key,
        jnp.float32(alpha), jnp.float32(dens), *tables))
    got = lisa_augment_core(
        _t(pad.points), _t(pad.mask),
        _lisa_draws(key, 4096, jl.max_droplets, jl.tail_droplets),
        torch.tensor(alpha, dtype=torch.float32),
        torch.tensor(dens, dtype=torch.float32),
        lisa_tables_to_torch([np.asarray(t) for t in tables], "cpu"),
        tl.core_config(),
    )
    flips = _assert_parity(want.points, got.points, want.keep, got.keep, 4)
    assert int(got.droplet_overflow) == int(want.droplet_overflow)
    for name in ("num_lost", "num_scattered", "num_attenuated"):
        assert abs(int(getattr(got, name)) - int(getattr(want, name))) \
            <= flips, name


def test_lisa_reference_contract(cloud):
    """The viewer's consumption pattern (test_weather_baselines.py's
    contract test, on the port): (N, 6), label 0 lost at the origin / 1
    attenuated / 2 scattered, diff only on attenuated points, deterministic
    under fixed_seed, intensity scale kept; augment_compact agrees."""
    lisa = LISA(dsd_points=64, device="cpu")
    aug1 = lisa.augment(cloud, 10.0, fixed_seed=True)
    aug2 = lisa.augment(cloud, 10.0, fixed_seed=True)
    np.testing.assert_array_equal(aug1, aug2)
    assert aug1.shape == (len(cloud), 6)
    assert set(np.unique(aug1[:, 4])) <= {0.0, 1.0, 2.0}
    lost = aug1[:, 4] == 0
    np.testing.assert_array_equal(aug1[lost, :3], 0.0)
    att = aug1[:, 4] == 1
    assert (aug1[att, 5] >= 0).all()
    np.testing.assert_array_equal(aug1[~att, 5], 0.0)
    assert aug1[:, 3].max() > 1.5
    comp, stats = lisa.augment_compact(cloud, 10.0, fixed_seed=True)
    assert len(comp) == int((~lost).sum())
    assert stats["num_lost"] == int(lost.sum())
    assert stats["droplet_overflow"] == 0
    norm = cloud.copy()
    norm[:, 3] /= 255.0
    assert lisa.augment(norm, 10.0, fixed_seed=True)[:, 3].max() <= 1.0


def test_lisa_droplet_capacity_never_silently_clamped(cloud):
    """test_weather_baselines.py:360 in the port: an undersized candidate
    set is detected by the residual bound and grown, and the healed result
    equals a run sized that way from the start."""
    lisa = LISA(dsd_points=64, max_droplets=4, tail_droplets=2,
                device="cpu")
    _, stats = lisa.augment_compact(cloud, 30.0, fixed_seed=True)
    assert stats["droplet_overflow"] == 0
    assert lisa.max_droplets > 4 and lisa.tail_droplets == \
        lisa.max_droplets // 2
    big = LISA(dsd_points=64, max_droplets=lisa.max_droplets,
               tail_droplets=lisa.tail_droplets, device="cpu")
    _, stats_b = big.augment_compact(cloud, 30.0, fixed_seed=True)
    assert stats_b == stats


def test_lisa_overflow_persisting_raises(cloud, monkeypatch):
    """Six growths without a clean run raise rather than return a
    truncated result."""
    import lidar_snow_sim_tpu_torch.models.lisa as tlisa

    def always_overflowing(*args, **kwargs):
        return res._replace(droplet_overflow=torch.tensor(1))

    lisa = LISA(dsd_points=64, device="cpu")
    res, _ = lisa._run(cloud[:64], 10.0, True, 0)
    monkeypatch.setattr(tlisa, "lisa_augment_core", always_overflowing)
    with pytest.raises(RuntimeError, match="overflow persisted"):
        lisa.augment(cloud[:64], 10.0, fixed_seed=True)
    assert lisa.max_droplets == 32 * 2**6


# ---------------- fog ----------------


def _fog_draws(key, n):
    """fog_augment's streams (fog.py:248-249)."""
    return (_t(jax.random.uniform(key, (n,), minval=-1.0, maxval=1.0)),
            _t(jax.random.normal(jax.random.fold_in(key, 1), (n,))))


@pytest.mark.parametrize("alpha", [0.005, 0.02, 0.06])
def test_soft_response_curve_matches_jax(alpha):
    p = fog.FogParameterSet(alpha=alpha)
    r_j, s_j = jfog.soft_response_curve(jfog.FogParameterSet(alpha=alpha))
    r_t, s_t = fog.soft_response_curve(p)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-12)


@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4"])
@pytest.mark.parametrize("alpha,gamma", [(0.005, 1e-6), (0.06, 1e-6),
                                         (0.03, 1e-5)])
def test_fog_augment_matches_jax(cloud, alpha, gamma, variant):
    kw = dict(alpha=alpha, gamma=gamma, noise_variant=variant)
    pad = pad_cloud(cloud, 4096)
    key = jax.random.PRNGKey(11)
    want = jax.device_get(jax.jit(jfog.fog_augment, static_argnames=("p",))(
        jfog.FogParameterSet(**kw), jnp.asarray(pad.points),
        jnp.asarray(pad.mask), key))
    got = fog.fog_augment(fog.FogParameterSet(**kw), _t(pad.points),
                          _t(pad.mask), _fog_draws(key, 4096))
    flips = _assert_parity(want.points, got.points, want.keep, got.keep, 4,
                           atol=1e-4)
    assert int(got.num_removed) == int(want.num_removed) == 0
    for name in ("num_scattered", "num_attenuated"):
        assert abs(int(getattr(got, name)) - int(getattr(want, name))) \
            <= flips, name
    if int(want.num_scattered):
        for name in ("min_fog_response", "max_fog_response"):
            np.testing.assert_allclose(float(getattr(got, name)),
                                       float(getattr(want, name)), rtol=1e-5)


def test_fog_running_max_takes_first_bin_of_a_tie():
    """The scan of fog.py:206-218 from -1.0, taking a bin only when strictly
    greater: on a curve with ties the FIRST bin of the tied maximum wins."""
    soft = torch.tensor([0.0, 2.0, 1.0, 2.0, 2.0, 3.0, 3.0, 1.0, 0.0])
    pmax, pargmax = fog.running_max(soft)
    best, bidx, want_max, want_arg = -1.0, 0, [], []
    for i, x in enumerate(soft.tolist()):
        if x > best:
            best, bidx = x, i
        want_max.append(best)
        want_arg.append(bidx)
    assert pmax.tolist() == want_max
    assert pargmax.tolist() == want_arg == [0, 1, 1, 1, 1, 5, 5, 5, 5]


def test_simulate_fog_exact_viewer_contract(cloud):
    """The viewer's call pattern on the port: mutable ParameterSet,
    simulate_fog(p, pc, noise, gain, noise_variant) -> (pc, fog_pc, info)."""
    p = fog.ParameterSet(gamma=0.000001, gamma_min=0.0000001,
                         gamma_max=0.00001, gamma_scale=10000000)
    p.beta_0 = p.gamma / np.pi
    p.alpha = 0.06
    aug, fog_pc, info = fog.simulate_fog(p, cloud, 10, True, "v4",
                                          device="cpu")
    assert set(info) == {"min_fog_response", "max_fog_response",
                         "num_fog_responses"}
    assert len(aug) == len(cloud)
    assert info["num_fog_responses"] == len(fog_pc) > 0
    assert info["max_fog_response"] >= info["min_fog_response"] > 0
    assert abs(float(aug[:, 3].max()) - 255.0) < 1e-3
    aug2, fog_pts, stats = fog.simulate_fog_pc(
        fog.FogParameterSet(alpha=0.06), cloud, noise=10.0, device="cpu")
    assert aug2.shape[1] == 5 and len(fog_pts) == stats["num_scattered"]
    assert (fog_pts[:, 4] == 2.0).all()


# ---------------- STF fog ----------------


def test_beta_randomization_equals_jax():
    for seed in (0, 5):
        j = jstf.BetaRadomization(beta=0.06, seed=seed).propagate_in_time(10)
        t = stf_fog.BetaRadomization(beta=0.06, seed=seed).propagate_in_time(10)
        for name in ("amps", "phases", "ks"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        az = np.linspace(-np.pi, np.pi, 101).astype(np.float32)
        np.testing.assert_allclose(t.get_beta(az).numpy(),
                                   np.asarray(j.get_beta(jnp.asarray(az))),
                                   rtol=1e-6)
    assert stf_fog.BetaRadomization is stf_fog.BetaRandomization


@pytest.mark.parametrize("beta", [0.02, 0.046, 0.15])
def test_haze_point_cloud_matches_jax(cloud, beta):
    b = jstf.BetaRadomization(beta=beta, seed=1)
    pad = pad_cloud(cloud, 4096)
    key = jax.random.PRNGKey(5)
    want = jax.device_get(jax.jit(jstf.haze_point_cloud_padded)(
        jnp.asarray(pad.points), jnp.asarray(pad.mask), b.coefficients(),
        key))
    draws = tuple(_t(jax.random.uniform(k, (4096,)))
                  for k in jax.random.split(key, 3))
    got = stf_fog.haze_point_cloud_padded(
        _t(pad.points), _t(pad.mask),
        stf_fog.BetaRadomization(beta=beta, seed=1).coefficients(), draws)
    flips = _assert_parity(want.points, got.points, want.keep, got.keep, 4,
                           atol=1e-4)
    for name in ("num_scattered", "num_attenuated", "num_removed"):
        assert abs(int(getattr(got, name)) - int(getattr(want, name))) \
            <= flips, name


def test_stf_fog_viewer_contract_and_counts(cloud):
    from argparse import Namespace

    b = stf_fog.BetaRadomization(beta=0.06, seed=0)
    b.propagate_in_time(10)
    pc = stf_fog.haze_point_cloud(
        cloud, b, Namespace(sensor_type="Velodyne HDL-64E S3D",
                            fraction_random=0.05), device="cpu")
    assert pc.shape[1] == cloud.shape[1] and 0 < len(pc) <= len(cloud)
    assert set(np.unique(pc[:, 4])) <= {0.0, 2.0}
    aug, stats = stf_fog.StfFogAugmenter(beta=0.05, seed=1, device="cpu")(cloud)
    assert stats["num_scattered"] + stats["num_attenuated"] == len(aug)
    assert stats["num_removed"] == len(cloud) - len(aug)
    _, dense = stf_fog.StfFogAugmenter(beta=0.15, seed=1,
                                       device="cpu")(cloud)
    assert dense["num_removed"] + dense["num_scattered"] > \
        stats["num_removed"] + stats["num_scattered"]


# ---------------- DROR ----------------

_RAD = math.radians(0.45)
_COEF = float(np.float32(3.0) * np.float32(_RAD))


def _padded(pc, block):
    cap = ((len(pc) + block - 1) // block) * block
    xyz = np.full((cap, 3), 1e6, np.float32)
    xyz[: len(pc)] = pc[:, :3]
    mask = np.zeros(cap, bool)
    mask[: len(pc)] = True
    return xyz, mask


def _jax_args(xyz, mask):
    return (jnp.asarray(xyz), jnp.asarray(mask), jnp.float32(_RAD),
            jnp.float32(3.0), jnp.int32(3), jnp.float32(0.04))


def _near_boundary(pc, tol=1e-3):
    """Points with some pair within `tol` m of their DROR radius."""
    _, d, sr = _dror_numpy_counts(pc)
    gap = np.abs(d - sr[:, None])
    np.fill_diagonal(gap, 1.0)
    return (gap < tol).any(axis=1)


@pytest.mark.parametrize("case", ["safe", "raw", "seam_overflow"])
def test_dror_kernels_match_jax(case):
    """Windowed (block 256, window 2048, margin 1024) and full-N searches of
    both packages on the same padded cloud: equal overflow counts, keep
    masks equal off the radius boundary; "seam_overflow" adds a point whose
    radius reaches past its horizontal range (counted, never truncated)."""
    pc, _ = _boundary_safe_cloud(seed=3)
    if case == "raw":
        rng = np.random.default_rng(9)
        th = rng.uniform(-np.pi, np.pi, 4000)
        r = rng.uniform(2, 80, 4000)
        pc = np.column_stack([r * np.cos(th), r * np.sin(th),
                              rng.uniform(-2, 1, 4000)]).astype(np.float32)
    if case == "seam_overflow":
        pc = np.vstack([pc, np.array([[0.01, 0.0, 0.5]], np.float32)])
    free = ~_near_boundary(pc)
    xyz, mask = _padded(pc, 256)
    keep_j, ovf_j = jdror._jit_dror_windowed(
        *_jax_args(xyz, mask), block=256, window=2048, margin=1024)
    keep_w, ovf_w = dror.dror_windowed(
        _t(xyz), _t(mask), _COEF, 3, float(np.float32(0.04)),
        block=256, window=2048, margin=1024)
    assert int(ovf_w) == int(ovf_j)
    assert (int(ovf_w) > 0) == (case == "seam_overflow")
    n = len(pc)
    full_j = np.asarray(jdror._jit_dror(*_jax_args(xyz, mask), block=256))
    full_t = dror.dror_full(_t(xyz), _t(mask), _COEF, 3,
                            float(np.float32(0.04))).numpy()
    np.testing.assert_array_equal(full_t[:n][free], full_j[:n][free])
    if case == "safe":
        assert free.all()
    if not int(ovf_w):
        np.testing.assert_array_equal(keep_w.numpy()[:n][free],
                                      np.asarray(keep_j)[:n][free])
        np.testing.assert_array_equal(keep_w.numpy()[:n][free],
                                      full_t[:n][free])
    # the host wrapper: windowed, grown once, then the exact full search
    np.testing.assert_array_equal(
        dror.dynamic_radius_outlier_filter(pc, device="cpu")[free],
        jdror.dynamic_radius_outlier_filter(pc)[free])
    np.testing.assert_array_equal(
        dror.dynamic_radius_outlier_filter(pc, window=0, device="cpu"),
        full_t[:n])


@pytest.mark.parametrize("m", [3, 57, 300, 1000])
def test_dror_tiny_and_ragged_clouds(m):
    """n < block, n < margin, n off a block multiple: windowed == full in
    the port, and equal to the JAX wrapper."""
    pc, _ = _boundary_safe_cloud(seed=3)
    sub = pc[:m]
    keep = dror.dynamic_radius_outlier_filter(sub, device="cpu")
    np.testing.assert_array_equal(
        keep, dror.dynamic_radius_outlier_filter(sub, window=0,
                                                 device="cpu"))
    np.testing.assert_array_equal(
        keep, jdror.dynamic_radius_outlier_filter(sub))


def test_dror_keeps_dense_removes_sparse_and_scales_with_range():
    rng = np.random.default_rng(0)
    grid = np.stack(np.meshgrid(np.linspace(-1, 1, 40),
                                np.linspace(-1, 1, 40)), axis=-1).reshape(-1, 2)
    wall = np.column_stack([np.full(len(grid), 10.0), grid[:, 0], grid[:, 1]])
    floaters = rng.uniform(-40, 40, (50, 3)) + np.array([60, 0, 0])
    keep = dror.dynamic_radius_outlier_filter(
        np.vstack([wall, floaters]).astype(np.float32), device="cpu")
    assert keep[: len(wall)].all() and not keep[len(wall):].any()

    def line_at(dist):
        return np.column_stack([np.full(30, dist), np.arange(30) * 0.12,
                                np.zeros(30)]).astype(np.float32)

    assert not dror.dynamic_radius_outlier_filter(line_at(2.0),
                                                  device="cpu").any()
    assert dror.dynamic_radius_outlier_filter(line_at(60.0),
                                              device="cpu").all()


def test_dror_snow_stats_cube_levels_and_pickles(cloud, tmp_path):
    pc = np.array([[5.0, 0.0, 0.0, 0, 0], [30.0, 0.0, 0.0, 0, 0],
                   [5.0, -20.0, 0.0, 0, 0]], np.float32)
    assert dror.get_cube_mask(pc).tolist() == [True, False, False]
    assert dror.snow_level(10) == "light"
    assert dror.snow_level(dror.DROR_LEVELS["medium"][0]) == "medium"
    assert dror.snow_level(10**6) == "heavy"
    assert dror.DROR_LEVELS == jdror.DROR_LEVELS
    assert dror.dror_snow_stats(cloud, device="cpu") == \
        jdror.dror_snow_stats(cloud)

    base = tmp_path / "alpha_0.45" / "all" / "hdl64" / "strongest"
    (base / "full").mkdir(parents=True)
    (base / "crop").mkdir(parents=True)
    with open(base / "full" / "frame_0001.pkl", "wb") as f:
        pickle.dump(np.array([0, 3, 7]), f)
    with open(base / "crop" / "frame_0001.pkl", "wb") as f:
        pickle.dump(np.arange(dror.DROR_LEVELS["medium"][0]), f)
    for mod in (dror, jdror):
        assert mod.precomputed_dror_mask(
            tmp_path, "hdl64", "strongest", "full", 10, "frame_0001.bin"
        ).tolist() == [False, True, True, False, True, True, True, False,
                       True, True]
        assert mod.precomputed_snow_severity(
            tmp_path, "hdl64", "strongest", "frame_0001.bin"
        ) == (dror.DROR_LEVELS["medium"][0], "medium")
        assert mod.precomputed_snow_severity(
            tmp_path, "hdl64", "strongest", "missing.bin"
        ) == (-1, "file not found")
