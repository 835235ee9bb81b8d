"""The plain versions of the window assembly's kernels W1
(`ops/occluders.occluders_window_plain`) and W2
(`ops/pulse.window_pulse_plain`) against the JAX package's `_occluder_phase`
and `_pulse_phase` on the CPU, and their wrappers and callers on CPU tensors.

The scenes are tests/test_snowfall_parity.py's (through
tests/test_torch_snowfall.py's `_scene`), channel-sorted, with the plane
and the channel order injected, and the "fov" scan in ten times its flakes
("dense"); each runs at its comfortable config and a starved one
(max_occluders 2, max_bumps 1), whose occluder and bump overflows are
nonzero on "dense" (the sparse scenes have no point behind 3 flakes). The
candidates are gathered once, as the JAX package's `chunk_fn` gathers them
(models/snowfall.py:356-368), from the port's per-point rows, window
starts and azimuths, and handed to both.
Tolerances:
- W1: the hit sets, ranges, validity and overflows equal; a1/a2 where valid
  within 4 float32 ulp of the larger of the angle and 1 (torch and XLA
  compute atan2 and asin differently; tests/test_torch_window.py);
- W2 with the decision tail, on the JAX occluders: labels, intensities and
  the bump overflow equal, xyz within 1e-6, the intensity-difference sum
  within 1e-4 relative (the sweep's sums run in another order).
The wrappers on CPU tensors run these plain versions and count no launch;
the kernels' calls over all points at once (as `window_augment` makes them
on the card) equal the same calls chunk by chunk (its plain path) byte for
byte.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.config import SnowfallConfig as JaxSnowfallConfig
from lidar_snow_sim_tpu.models import snowfall as jsnow
from lidar_snow_sim_tpu_torch import build_bank, load_hdl64_calib, pad_cloud
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops import occluders as tocc
from lidar_snow_sim_tpu_torch.ops import pulse as tpulse
from test_torch_snowfall import PLANE, _sets
from test_torch_window import _close_angles, _sorted_scene
from test_torch_window_cuda import _same

STARVED = dict(max_occluders=2, max_bumps=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(scene):
    """(pc, particle sets, cfg, bank) of a channel-sorted scene: "fov" and
    "seam" as tests/test_torch_window.py's; "dense", the "fov" scan in ten
    times its flakes (3,000 a channel, some points behind 3 or more), with a
    wide list of 128."""
    pc, sets, cfg = _sorted_scene("fov" if scene == "dense" else scene)
    wide = 64
    if scene == "dense":
        sets, wide = _sets(5, 3000, np.pi, np.pi, 60, 0.05), 128
        cfg = dataclasses.replace(cfg, wide_capacity=wide)
    return pc, sets, cfg, build_bank(sets, window_size=256,
                                     wide_capacity=wide)


def _inputs(scene, starved=False):
    """(cfg, bank, bank tensors, WindowInputs) of a channel-sorted scene on
    the CPU, the plane injected."""
    pc, sets, cfg, bank = _scene(scene)
    if starved:
        cfg = dataclasses.replace(cfg, **STARVED)
    bank_t = ts.bank_to_torch(bank, "cpu")
    padded = pad_cloud(pc, cfg.max_points)
    plane = (torch.tensor(PLANE[0], dtype=torch.float32),
             torch.tensor(PLANE[1], dtype=torch.float32))
    inp = ts.window_inputs(
        torch.as_tensor(padded.points), torch.as_tensor(padded.mask), bank_t,
        ts.calib_to_torch(load_hdl64_calib(), "cpu"),
        torch.as_tensor(np.random.default_rng(3).permutation(64)), None, cfg,
        plane=plane)
    return cfg, bank, bank_t, inp


def _jax_candidates(bank, inp, cfg):
    """The JAX chunk_fn's (P, S + W, 4) candidates of every point."""
    k_ext = bank.angle.shape[1]
    row, lo = inp.bank_row.numpy(), inp.lo.numpy()
    center = inp.feats[:, 8].numpy()
    delta = ts.window_delta(cfg)
    widx = np.clip(lo[:, None] + np.arange(cfg.window_size), 0, k_ext - 1)
    wcand = bank.data[row[:, None], widx].copy()
    wang = bank.angle[row[:, None], widx]
    in_win = (wang >= (center - np.float32(delta))[:, None]) & (
        wang <= (center + np.float32(delta))[:, None])
    wcand[:, :, 3] = np.where(in_win, wcand[:, :, 3], np.float32(1e9))
    return np.concatenate([wcand, bank.wide[row]], axis=1)


def _jax_occluders(bank, inp, cfg):
    jcfg = JaxSnowfallConfig(**dataclasses.asdict(cfg))
    return [np.asarray(v) for v in jax.jit(
        jsnow._occluder_phase, static_argnames=("cfg",))(
        jnp.asarray(inp.xyz.numpy()),
        jnp.asarray(_jax_candidates(bank, inp, cfg)), cfg=jcfg)]


@pytest.mark.parametrize("starved", [False, True])
@pytest.mark.parametrize("scene", ["fov", "seam", "dense"])
def test_occluders_window_plain_matches_jax(scene, starved):
    cfg, bank, bank_t, inp = _inputs(scene, starved)
    args, kw = ts.window_occluder_call(inp, bank_t, cfg)
    got = [v.numpy() for v in tocc.occluders_window_plain(
        *args, **dict(kw, live=None))]
    want = _jax_occluders(bank, inp, cfg)
    valid = want[3]
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[4], want[4])
    assert valid.sum() > 50
    for g, w in zip(got[:2], want[:2]):
        _close_angles(g[valid], w[valid])
        assert (g[~valid] == 0).all()     # the empty slots' a1, a2
    mask = inp.mask.numpy()
    assert (int(got[4][mask].sum()) > 0) == (starved and scene == "dense")


@pytest.mark.parametrize("starved", [False, True])
@pytest.mark.parametrize("scene", ["fov", "seam", "dense"])
def test_window_pulse_plain_matches_jax(scene, starved):
    """window_pulse_plain and the decision tail against the JAX
    `_pulse_phase` on the JAX package's occluders (its empty slots keep
    whatever a1/a2 top_k took there; both sweeps mask them)."""
    cfg, bank, _, inp = _inputs(scene, starved)
    occ = _jax_occluders(bank, inp, cfg)
    jcfg = JaxSnowfallConfig(**dataclasses.asdict(cfg))
    grid = cfg.range_grid()
    want = [np.asarray(v) for v in jax.jit(
        jsnow._pulse_phase, static_argnames=("cfg",))(
        *(jnp.asarray(t.numpy()) for t in (inp.xyz, inp.intensity,
                                           inp.mask)),
        *(jnp.asarray(v) for v in occ[:4]),
        *(jnp.asarray(t.numpy()) for t in (inp.min_int, inp.max_int,
                                           inp.focal_slope,
                                           inp.focal_offset)),
        jnp.asarray(grid), cfg=jcfg)]
    t_occ = [torch.tensor(v) for v in occ[:4]]
    peak, idx, touched, bump_of = tpulse.window_pulse_plain(
        inp.feats, inp.max_int, *t_occ, torch.as_tensor(grid),
        beam_rad=cfg.beam_divergence_rad, ipm=cfg.intervals_per_meter,
        tau_h=cfg.tau_h, max_bumps=cfg.max_bumps)
    new_xyz, new_int, label, diff = ts._pulse_tail(
        inp.xyz, inp.intensity, inp.mask, peak, idx, touched, inp.min_int,
        inp.max_int, inp.focal_slope, inp.focal_offset, cfg)
    np.testing.assert_array_equal(label.numpy(), want[2])
    np.testing.assert_array_equal(new_int.numpy(), want[1])
    np.testing.assert_allclose(new_xyz.numpy(), want[0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(diff.sum()), float(want[3]), rtol=1e-4)
    bump_sum = int(torch.where(inp.mask, bump_of, 0).sum())
    assert bump_sum == int(want[4])
    assert (bump_sum > 0) == starved
    assert (label.numpy() > 0).sum() > 10


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    """find_occluders_window and window_pulse_peaks on CPU tensors return
    their plain versions' outputs and leave the launch counters as they
    were."""
    cfg, _, bank_t, inp = _inputs("dense", starved=True)
    n0 = (tocc.find_occluders_window.launches,
          tpulse.window_pulse_peaks.launches)
    args, kw = ts.window_occluder_call(inp, bank_t, cfg)
    occ = tocc.find_occluders_window(*args, **kw)
    for a, b in zip(occ, tocc.occluders_window_plain(*args, **kw)):
        assert torch.equal(a, b)
    pargs, pkw = ts.window_pulse_call(inp, occ, cfg)
    for a, b in zip(tpulse.window_pulse_peaks(*pargs, **pkw),
                    tpulse.window_pulse_plain(*pargs, **pkw)):
        assert _same(a, b)
    assert (tocc.find_occluders_window.launches,
            tpulse.window_pulse_peaks.launches) == n0


def test_origin_point_peak_is_nan_at_bin_m():
    """A point at the origin (range 0) has a target amplitude of 0/0: its
    peak is NaN and its bin M, as torch's amax and the equality test give
    them (kernel W2 writes the same); a point at 10 m has a finite peak."""
    cfg = ts.SnowfallConfig()
    k = 4
    xyz = torch.tensor([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0]])
    zeros = torch.zeros((2, k))
    feats = tocc.point_features(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                cfg.beam_divergence_rad)
    peak, idx, touched, bump_of = tpulse.window_pulse_plain(
        feats, torch.full((2,), 255.0), zeros, zeros, torch.full(
            (2, k), float("inf")), torch.zeros((2, k), dtype=torch.bool),
        torch.as_tensor(cfg.range_grid()), beam_rad=cfg.beam_divergence_rad,
        ipm=cfg.intervals_per_meter, tau_h=cfg.tau_h, max_bumps=2)
    m = len(cfg.range_grid())
    assert peak[0].isnan() and int(idx[0]) == m
    assert peak[1].isfinite() and 0 < int(idx[1]) < m
    assert not touched.any() and not bump_of.any()


@pytest.mark.parametrize("starved", [False, True])
def test_window_kernel_path_equals_the_chunked_plain_path(starved):
    """W1's and W2's calls over all points at once, as `window_augment`
    makes them on the card (here the wrappers run their plain versions),
    against the same calls chunk by chunk of `point_chunk` points, as its
    plain path makes them: every output equal (a peak NaN where the other
    is)."""
    cfg, _, bank_t, inp = _inputs("dense", starved)
    n = inp.xyz.shape[0]
    assert n // cfg.point_chunk > 1
    args, kw = ts.window_occluder_call(inp, bank_t, cfg)
    occ = tocc.find_occluders_window(*args, **kw)
    pargs, pkw = ts.window_pulse_call(inp, occ, cfg)
    whole = (*occ, *tpulse.window_pulse_peaks(*pargs, **pkw))
    chunks = []
    for c0 in range(0, n, cfg.point_chunk):
        sl = slice(c0, c0 + cfg.point_chunk)
        args, kw = ts.window_occluder_call(inp, bank_t, cfg, sl)
        part = tocc.occluders_window_plain(*args, **kw)
        pargs, pkw = ts.window_pulse_call(inp, part, cfg, sl)
        chunks.append((*part, *tpulse.window_pulse_plain(*pargs, **pkw)))
    for name, a, parts in zip(
            ("a1", "a2", "dist", "valid", "occluder_overflow", "peak", "bin",
             "touched", "bump_overflow"), whole, zip(*chunks)):
        assert _same(a, torch.cat(parts)), name
    mask = inp.mask
    assert (int(occ[4][mask].sum()) > 0) == starved
    assert (int(whole[8][mask].sum()) > 0) == starved
