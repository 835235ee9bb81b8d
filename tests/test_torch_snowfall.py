"""The port's dense snowfall slice against the JAX package.

Both packages run the dense assembly on the same scan, bank, channel order
and injected ground plane; the JAX package runs its Pallas branch in
interpret mode (`use_pallas=True, pallas_interpret=True`), whose slice
geometry, and so whose overflow counters, the port keeps.

Contract (tests/test_snowfall_parity.py:115-187): the five overflow
counters are equal; labels, intensities and keep flags are equal except on
decision boundaries, judged by the oracle's hit-set and pulse-decision
margins and by the noise-floor margin, on fewer than 0.2% of points. torch
and XLA compute atan2, sin, cos, arccos and float32 sums in other orders,
and XLA's CPU backend fuses multiply-adds, so a value on a boundary may
fall either way. Moved (label 2) points may differ in xyz by a few ulp:
their new range divides by the point's norm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.calib import load_hdl64_calib
from lidar_snow_sim_tpu.config import SnowfallConfig
from lidar_snow_sim_tpu.models.snowfall import (
    calib_device_arrays,
    snowfall_augment,
)
from lidar_snow_sim_tpu.oracle.snowfall import (
    _wrap_02pi,
    hit_set_margins,
    occlusion_dicts,
    pulse_decision_margins,
)
from lidar_snow_sim_tpu.sampling.banks import build_bank
from lidar_snow_sim_tpu.utils.pointcloud import pad_cloud
from lidar_snow_sim_tpu.utils.synthetic import synthetic_scan
from lidar_snow_sim_tpu_torch.models import snowfall as ts

_W = np.array([0.005, -0.003, -1.0])
PLANE = (_W / np.linalg.norm(_W), -1.55)
COUNTERS = ts.OVERFLOW_COUNTERS
BASE = dict(max_points=8192, window_size=256, wide_capacity=64,
            max_occluders=48, max_bumps=24, point_chunk=256,
            assembly="dense", channel_capacity=128, block_points=32,
            slice_width=256)
_EPS = dict(   # the parity test's boundary widths
    peak_tie=1e-4, range_margin=1e-3, int_margin=1e-3, bin_margin=1e-4,
    min_ratio=1e-5, cull=1e-3, tangency=1e-5, angle=1e-6,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are small: one intra-op thread per test worker keeps
    the workers from oversubscribing the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sets(seed, n, center, spread, dmax, rmax):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(64):
        ang = center + rng.uniform(-spread, spread, n)
        d = np.sqrt(rng.uniform(0.01, 1, n)) * dmax
        r = rng.uniform(0.005 if rmax < 0.06 else 0.01, rmax, n)
        out.append(np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))
    return out


def _scene(name):
    """(pc, particle sets, cfg) of one test scene."""
    calib = load_hdl64_calib()
    if name == "fov":
        pc = synthetic_scan(n_azimuth=100, seed=2, calib=calib)
        return pc, _sets(5, 300, np.pi, np.pi, 60, 0.05), BASE
    pc = synthetic_scan(n_azimuth=100, fov_deg=360.0, seed=4, calib=calib)
    pc = pc[np.argsort(pc[:, 4], kind="stable")][:8192]
    if name == "360":   # crosses the +-pi azimuth seam
        return pc, _sets(5, 300, np.pi, np.pi, 60, 0.05), dict(
            BASE, max_bumps=48, block_points=16, slice_width=384)
    # "seam": flakes clustered at the seam, so slices hold wrap-pad copies
    return pc, _sets(7, 40, np.pi, 0.4, 40, 0.08), dict(
        BASE, max_occluders=16, max_bumps=16)


def _run_jax(pc, bank, order, cfg):
    calib = load_hdl64_calib()
    padded = pad_cloud(pc, cfg.max_points)
    cfg = dataclasses.replace(cfg, use_pallas=True, pallas_interpret=True)
    return jax.device_get(jax.jit(snowfall_augment, static_argnames=("cfg",))(
        jnp.asarray(padded.points), jnp.asarray(padded.mask),
        jax.device_put(bank), calib_device_arrays(calib),
        jnp.asarray(order, jnp.int32), jax.random.PRNGKey(0), cfg,
        plane=(jnp.asarray(PLANE[0], jnp.float32), jnp.float32(PLANE[1])),
    ))


def _run_port(pc, bank, order, cfg):
    calib = load_hdl64_calib()
    padded = pad_cloud(pc, cfg.max_points)
    pts = torch.as_tensor(padded.points)
    mask = torch.as_tensor(padded.mask)
    plane = (torch.tensor(PLANE[0], dtype=torch.float32),
             torch.tensor(PLANE[1], dtype=torch.float32))
    res = ts.snowfall_augment_dense(
        pts, mask, ts.bank_to_torch(bank, "cpu"),
        ts.calib_to_torch(calib, "cpu"), torch.as_tensor(order), None, cfg,
        plane=plane,
    )
    noise_at = ts._plane_and_noise(
        pts[:, :3], pts[:, 3], mask, torch.linalg.vector_norm(pts[:, :3],
                                                              dim=-1),
        None, cfg, plane,
    )
    return res, noise_at.numpy()


def _on_boundary(pc, j, sets, order, noise_at, new_int):
    """Whether point j's decision sits on an f32-sensitive boundary."""
    calib = load_hdl64_calib()
    if abs(float(new_int) - float(noise_at[j])) < 1e-3:
        return True
    ch = int(pc[j, 4])
    p = pc[j].astype(np.float64)
    d = float(np.linalg.norm(p[:3]))
    beam_rad = np.radians(SnowfallConfig().beam_divergence_deg)
    center = _wrap_02pi(np.arctan2(p[1:2], p[0:1]))
    right = _wrap_02pi(center - beam_rad / 2)[0]
    left = _wrap_02pi(center + beam_rad / 2)[0]
    particles = sets[order[ch]]
    occl = occlusion_dicts(np.array([[right, left]]), np.array([d]),
                           particles, SnowfallConfig().beam_divergence_deg)
    margins = pulse_decision_margins(
        d, p[3], occl[0], ch, float(calib.min_intensity[ch]),
        float(calib.focal_distance[ch]), float(calib.focal_slope[ch]),
    )
    margins.update(hit_set_margins(p[:3], d, right, left, particles))
    return any(margins[k] < eps for k, eps in _EPS.items())


def _assert_parity(pc, sets, order, rj, rt, noise_at):
    for name in COUNTERS:
        assert int(getattr(rt, name)) == int(getattr(rj, name)), name
    n = len(pc)
    pj = np.asarray(rj.planes)[:, :n]
    pt = rt.planes.numpy()[:, :n]
    kj, kt = np.asarray(rj.keep)[:n], rt.keep.numpy()[:n]
    off = np.where((pj[3:] != pt[3:]).any(axis=0) | (kj != kt))[0]
    assert len(off) / n < 0.002, f"{len(off)} of {n} points differ"
    unexplained = [
        j for j in off
        if not _on_boundary(pc, j, sets, order, noise_at, pt[3, j])
    ]
    assert not unexplained, f"off-boundary mismatches at {unexplained[:5]}"
    same = np.setdiff1d(np.arange(n), off)
    np.testing.assert_allclose(pt[:3, same], pj[:3, same], rtol=1e-6,
                               atol=1e-6)
    for stat in ("num_attenuated", "num_removed"):
        assert abs(int(getattr(rt, stat)) - int(getattr(rj, stat))) <= len(off)
    if not len(off):
        assert int(rt.avg_intensity_diff) == int(rj.avg_intensity_diff)


@pytest.mark.parametrize("scene", ["fov", "360", "seam"])
def test_dense_slice_matches_jax(scene):
    pc, sets, base = _scene(scene)
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    cfg = SnowfallConfig(**base)
    rj = _run_jax(pc, bank, order, cfg)
    rt, noise_at = _run_port(pc, bank, order, cfg)
    assert all(int(getattr(rt, c)) == 0 for c in COUNTERS)
    labels = rt.planes[4, :len(pc)].numpy()
    assert (labels > 0).sum() > 10   # the scene has snow effects
    _assert_parity(pc, sets, order, rj, rt, noise_at)


def test_slice_wider_than_bank_row():
    """A slice wider than the bank row (the capacity healers grow it up to
    the row) is clipped to the row and gives the output of a narrow one
    (the JAX package takes its XLA dense branch there)."""
    pc, sets, base = _scene("fov")
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    assert bank.angle.shape[1] < 2048
    order = np.random.default_rng(3).permutation(64)
    narrow, _ = _run_port(pc, bank, order, SnowfallConfig(**base))
    wide, _ = _run_port(pc, bank, order,
                        SnowfallConfig(**dict(base, slice_width=2048)))
    for a, b in zip(narrow, wide):
        assert torch.equal(a, b)


@pytest.mark.parametrize("starve,fires", [
    (dict(slice_width=8), "window_overflow"),
    (dict(max_occluders=1, max_bumps=1), "occluder_overflow"),
])
def test_starved_capacities_count_like_jax(starve, fires):
    """Capacities too small: the counters fire with the JAX Pallas branch's
    counts."""
    pc, sets, base = _scene("fov")
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    cfg = SnowfallConfig(**dict(
        base, channel_capacity=64, compact_capacity=64, pulse_chunk=64,
        touch_capacity=16, scatter_capacity=16, **starve,
    ))
    rj = _run_jax(pc, bank, order, cfg)
    rt, _ = _run_port(pc, bank, order, cfg)
    got = {c: int(getattr(rt, c)) for c in COUNTERS}
    assert got == {c: int(getattr(rj, c)) for c in COUNTERS}
    for c in (fires, "channel_overflow", "compact_overflow"):
        assert got[c] > 0, c


def test_capacities_grow_to_the_comfortable_result():
    """Too small a channel, slice, occluder and compact capacity grow and
    rerun; the output equals a comfortably sized run."""
    pc, sets, base = _scene("fov")
    calib = load_hdl64_calib()
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    ok = ts.SnowfallAugmenter(bank, calib, SnowfallConfig(**base))
    tight = ts.SnowfallAugmenter(bank, calib, SnowfallConfig(**dict(
        base, channel_capacity=32, slice_width=64, max_occluders=1,
        max_bumps=1, compact_capacity=256, pulse_chunk=256,
    )))
    stats_ok, out_ok = ok(pc, order=order)
    stats_t, out_t = tight(pc, order=order)
    assert tight.cfg.channel_capacity > 32
    assert tight.cfg.max_occluders > 1
    assert stats_t == stats_ok
    np.testing.assert_array_equal(out_t, out_ok)
    assert all(int(getattr(tight.last_result, c)) == 0 for c in COUNTERS)
    assert set(np.unique(out_t[:, 4])) <= {0.0, 1.0, 2.0}


@pytest.mark.parametrize("change", [
    dict(assembly="window"), dict(route_band=384), dict(band_width=256),
])
def test_unported_paths_raise(change):
    pc, sets, base = _scene("fov")
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.SnowfallAugmenter(bank, load_hdl64_calib(),
                             SnowfallConfig(**dict(base, **change)))
