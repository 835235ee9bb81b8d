"""The port's window assembly (`models/snowfall.snowfall_augment` with
`assembly="window"`, `ops/geometry.candidate_intervals`, `ops/sweep`,
`ops/waveform`) against the JAX package on the CPU.

The ops take seeded inputs, with beams that cross the 0/2pi seam. Their
tolerances:
- `intersects`, `touched`, `xsi`: equal;
- the interval angles a1, a2: within 4 float32 ulp of the larger of the
  angle and 1 (torch and XLA compute atan2 and asin differently, and XLA's
  CPU backend fuses px * sin - py * cos into a multiply-add);
- ratio and remainder: within 1e-6 absolute (the claims' float32 sums run
  in another order);
- the waveform peak: within 1e-6 relative; its bin equal, unless the JAX
  waveform's value at the port's bin lies within 1e-6 relative of its peak
  (a tie that rounding may break either way).

The whole window path runs on the scenes of tests/test_snowfall_parity.py
and tests/test_torch_snowfall.py with the plane and the channel order
injected, under the parity contract of tests/test_snowfall_parity.py:
115-186 (`_assert_parity`): equal counters, labels, intensities and keep
flags except on decision boundaries on under 0.2% of points, xyz within
1e-6. On a channel-sorted scan with zero overflows the port's window and
dense assemblies give the same output bit for bit. The batched step and the
datagen run a window config frame by frame: `batched_step` against the JAX
package's on 2 frames (the same contract), `datagen_packed_step` equal to
`batched_step` byte for byte.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.config import SnowfallConfig as JaxSnowfallConfig
from lidar_snow_sim_tpu.models.snowfall import (
    calib_device_arrays,
    snowfall_augment as jax_snowfall_augment,
)
from lidar_snow_sim_tpu.ops import geometry as jgeo
from lidar_snow_sim_tpu.ops import sweep as jsweep
from lidar_snow_sim_tpu.ops import waveform as jwave
from lidar_snow_sim_tpu.oracle.snowfall import augment as augment_oracle
from lidar_snow_sim_tpu.oracle.snowfall import (
    _wrap_02pi,
    hit_set_margins,
    occlusion_dicts,
    pulse_decision_margins,
    resimulate_channel,
)
from lidar_snow_sim_tpu.sampling.banks import ParticleBank as JaxParticleBank
from lidar_snow_sim_tpu_torch import (
    SnowfallConfig,
    build_bank,
    load_hdl64_calib,
    pad_cloud,
    synthetic_scan,
)
from lidar_snow_sim_tpu_torch.models import snowfall as ts
from lidar_snow_sim_tpu_torch.ops import geometry as tgeo
from lidar_snow_sim_tpu_torch.ops import sweep as tsweep
from lidar_snow_sim_tpu_torch.ops import waveform as twave
from test_torch_snowfall import COUNTERS, PLANE, _assert_parity, _batch, _scene

BEAM_RAD = SnowfallConfig().beam_divergence_rad
WINDOW = dict(max_points=8192, window_size=256, wide_capacity=64,
              max_occluders=48, max_bumps=24, point_chunk=256,
              assembly="window")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _beams(rng, p, wrapped: bool):
    """(x, y, right, left, d) of p beams; `wrapped` puts every azimuth
    within half a beam of 0, so the wedges cross the seam."""
    if wrapped:
        az = rng.uniform(-BEAM_RAD / 2, BEAM_RAD / 2, p)
    else:
        az = rng.uniform(-np.pi, np.pi, p)
    d = rng.uniform(5, 60, p)
    x = (d * np.cos(az)).astype(np.float32)
    y = (d * np.sin(az)).astype(np.float32)
    right, left = (np.array(v) for v in jgeo.beam_limits(
        jnp.asarray(x), jnp.asarray(y), BEAM_RAD))
    return x, y, right, left, np.hypot(x, y).astype(np.float32)


def _close_angles(got, want, ulps: int = 4):
    tol = ulps * np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("wrapped", [False, True])
def test_candidate_intervals_matches_jax(wrapped):
    """Candidates around each beam's azimuth, half of them grazing an
    edge, on a (P, C) batch; the JAX function is vmapped over the beams."""
    rng = np.random.default_rng(1 + wrapped)
    p, c = 64, 96
    x, y, right, left, d = _beams(rng, p, wrapped)
    az = np.arctan2(y, x)[:, None] + rng.uniform(-3, 3, (p, c)) * BEAM_RAD
    pd = rng.uniform(1, 70, (p, c))
    px = (pd * np.cos(az)).astype(np.float32)
    py = (pd * np.sin(az)).astype(np.float32)
    pr = rng.uniform(0.005, 0.08, (p, c)).astype(np.float32)
    pdist = np.hypot(px, py).astype(np.float32)
    pvalid = rng.uniform(size=(p, c)) < 0.9
    want = [np.asarray(v) for v in jax.vmap(jgeo.candidate_intervals)(
        *(jnp.asarray(v) for v in (right, left, px, py, pr, pdist, pvalid,
                                   d)))]
    got = [v.numpy() for v in tgeo.candidate_intervals(
        *(torch.as_tensor(v) for v in (right, left, px, py, pr, pdist,
                                       pvalid, d)))]
    np.testing.assert_array_equal(got[2], want[2])
    assert 0 < want[2].sum() < want[2].size
    for g, w in zip(got[:2], want[:2]):
        _close_angles(g, w)


def _intervals(rng, p, k, wrapped):
    """Beams and K occluder intervals inside or across them, with ranks
    (column order) as the claim priority and some invalid slots."""
    _, _, right, left, _ = _beams(rng, p, wrapped)
    width = BEAM_RAD * rng.uniform(0.05, 0.6, (p, k))
    start = (right - TWO_PI * (right > left))[:, None] + rng.uniform(
        -0.3, 1.0, (p, k)) * BEAM_RAD
    a1 = np.mod(start, TWO_PI).astype(np.float32)
    a2 = np.mod(start + width, TWO_PI).astype(np.float32)
    # some intervals clipped to the beam's own edges, as candidate_intervals
    # clips them
    a1 = np.where(rng.uniform(size=(p, k)) < 0.2, right[:, None], a1)
    a2 = np.where(rng.uniform(size=(p, k)) < 0.2, left[:, None], a2)
    valid = rng.uniform(size=(p, k)) < 0.8
    return right, left, a1.astype(np.float32), a2.astype(np.float32), valid


TWO_PI = 2.0 * np.pi


@pytest.mark.parametrize("wrapped", [False, True])
def test_occlusion_sweep_matches_jax(wrapped):
    rng = np.random.default_rng(3 + wrapped)
    args = _intervals(rng, 128, 12, wrapped)
    want = [np.asarray(v) for v in jax.vmap(
        jsweep.occlusion_sweep, in_axes=(0, 0, 0, 0, 0, None))(
        *(jnp.asarray(v) for v in args), BEAM_RAD)]
    got = [v.numpy() for v in tsweep.occlusion_sweep(
        *(torch.as_tensor(v) for v in args), BEAM_RAD)]
    np.testing.assert_array_equal(got[2], want[2])          # touched
    assert 0 < want[2].sum() < want[2].size
    for g, w in zip(got[:2], want[:2]):                     # ratio, remainder
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert (want[1] > 0).any() and (want[1] < 1).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_waveform_peak_matches_jax(seed):
    """Bumps spread over the grid with some overlapping, zero amplitudes,
    and one beam of two equal bumps at the same range (an exact tie)."""
    cfg = SnowfallConfig()
    rng = np.random.default_rng(seed)
    p, b = 64, 9
    r = rng.uniform(0.5, 110, (p, 1)) + rng.uniform(0, 6, (p, b))
    amp = rng.uniform(0, 50, (p, b)) * (rng.uniform(size=(p, b)) < 0.8)
    r[0, 1], amp[0, 1] = r[0, 0], amp[0, 0]
    r, amp = r.astype(np.float32), amp.astype(np.float32)
    grid = cfg.range_grid()
    want_x = np.asarray(jwave.xsi(jnp.asarray(r)))
    np.testing.assert_array_equal(twave.xsi(torch.as_tensor(r)).numpy(),
                                  want_x)
    wpk, widx = (np.asarray(v) for v in jax.vmap(
        jwave.waveform_peak, in_axes=(0, 0, None, None, None))(
        jnp.asarray(r), jnp.asarray(amp), jnp.asarray(grid),
        cfg.intervals_per_meter, cfg.tau_h))
    gpk, gidx = (v.numpy() for v in twave.waveform_peak(
        torch.as_tensor(r), torch.as_tensor(amp), torch.as_tensor(grid),
        cfg.intervals_per_meter, cfg.tau_h))
    np.testing.assert_allclose(gpk, wpk, rtol=1e-6, atol=0)
    off = np.nonzero(gidx != widx)[0]
    if len(off):
        # the JAX waveform at the port's bin, summed as the JAX function
        # sums it, must tie with its peak
        def wave_at(i, m):
            c_tau = 299792458.0 * cfg.tau_h
            g = grid[m]
            tot = np.float32(0)
            for j in range(b):
                if m >= r[i, j] * 10 and m <= (r[i, j] + c_tau) * 10:
                    tot += amp[i, j] * np.float32(
                        np.sin(np.pi * (g - r[i, j]) / c_tau) ** 2)
            return tot
        for i in off:
            assert abs(wave_at(i, gidx[i]) - wpk[i]) <= 1e-6 * wpk[i] + 1e-6
    assert (widx > 0).all()


def _port_window(pc, bank, order, cfg, plane=PLANE, device="cpu"):
    """The port's window path on the padded scan, with the ground plane
    injected; returns (result, noise_at)."""
    calib = load_hdl64_calib()
    padded = pad_cloud(pc, cfg.max_points)
    pts = torch.as_tensor(padded.points, device=device)
    mask = torch.as_tensor(padded.mask, device=device)
    plane_t = (torch.tensor(plane[0], dtype=torch.float32, device=device),
               torch.tensor(plane[1], dtype=torch.float32, device=device))
    res = ts.snowfall_augment(
        pts, mask, ts.bank_to_torch(bank, device),
        ts.calib_to_torch(calib, device),
        torch.as_tensor(order, device=device), None, cfg, plane=plane_t)
    noise_at = ts._plane_and_noise(pts[:, :3], pts[:, 3], mask,
                                   tgeo.norm3(pts[:, :3]), None, cfg,
                                   plane_t)
    return res, noise_at.cpu().numpy()


def _jax_window(pc, bank, order, cfg):
    calib = load_hdl64_calib()
    padded = pad_cloud(pc, cfg.max_points)
    jcfg = JaxSnowfallConfig(**dataclasses.asdict(cfg))
    return jax.device_get(jax.jit(
        jax_snowfall_augment, static_argnames=("cfg",))(
        jnp.asarray(padded.points), jnp.asarray(padded.mask),
        jax.device_put(JaxParticleBank(*bank)), calib_device_arrays(calib),
        jnp.asarray(order, jnp.int32), jax.random.PRNGKey(0), jcfg,
        plane=(jnp.asarray(PLANE[0], jnp.float32), jnp.float32(PLANE[1])),
    ))


def _sorted_scene(name):
    """A test scene stable-sorted by channel (the window path's output
    order), its particle sets and the window config."""
    pc, sets, base = _scene(name)
    pc = pc[np.argsort(pc[:, 4], kind="stable")]
    cfg = SnowfallConfig(**dict(
        WINDOW, max_occluders=base["max_occluders"],
        max_bumps=base["max_bumps"]))
    return pc, sets, cfg


@pytest.mark.parametrize("scene", ["fov", "360", "seam"])
def test_window_matches_jax(scene):
    pc, sets, cfg = _sorted_scene(scene)
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    rj = _jax_window(pc, bank, order, cfg)
    rt, noise_at = _port_window(pc, bank, order, cfg)
    assert all(int(getattr(rt, c)) == 0 for c in COUNTERS)
    assert (rt.planes[4, :len(pc)].numpy() > 0).sum() > 10
    _assert_parity(pc, sets, order, rj, rt, noise_at)


def test_window_rows_come_back_channel_sorted():
    """A shuffled scan: the port's rows come back in the JAX package's
    order, stable-sorted by channel, under the same contract."""
    pc, sets, _ = _scene("fov")
    pc = pc[np.random.default_rng(0).permutation(len(pc))]
    cfg = SnowfallConfig(**WINDOW)
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    rj = _jax_window(pc, bank, order, cfg)
    rt, noise_at = _port_window(pc, bank, order, cfg)
    srt = pc[np.argsort(pc[:, 4], kind="stable")]
    np.testing.assert_array_equal(rt.planes[:3, :len(pc)].numpy()[
        :, rt.planes[4, :len(pc)].numpy() == 0], srt[:, :3][
        rt.planes[4, :len(pc)].numpy() == 0].T)
    _assert_parity(srt, sets, order, rj, rt, noise_at)


@pytest.mark.parametrize("scene", ["fov", "360"])
def test_window_equals_dense_bit_for_bit(scene):
    """On a channel-sorted scan with zero overflows the window and dense
    assemblies agree bit for bit, through SnowfallAugmenter too (the
    default window config, with the RANSAC draws of one seed)."""
    pc, sets, wcfg = _sorted_scene(scene)
    _, _, base = _scene(scene)
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    rw, _ = _port_window(pc, bank, order, wcfg)
    rd, _ = _port_window(pc, bank, order, SnowfallConfig(**base))
    for r in (rw, rd):
        assert all(int(getattr(r, c)) == 0 for c in COUNTERS)
    n = len(pc)
    assert torch.equal(rw.planes[:, :n], rd.planes[:, :n])
    assert torch.equal(rw.keep[:n], rd.keep[:n])
    for stat in ("num_attenuated", "num_removed", "avg_intensity_diff"):
        assert int(getattr(rw, stat)) == int(getattr(rd, stat)), stat

    calib = load_hdl64_calib()
    win = ts.SnowfallAugmenter(bank, calib, wcfg, device="cpu")
    dense = ts.SnowfallAugmenter(bank, calib, SnowfallConfig(**base),
                                 device="cpu")
    sw, ow = win(pc, order=order)
    sd, od = dense(pc, order=order)
    assert sw == sd
    np.testing.assert_array_equal(ow, od)
    assert win.cfg == wcfg


def test_default_config_runs_the_window_assembly(monkeypatch):
    """SnowfallConfig() names the window assembly, SnowfallAugmenter's
    default config is SnowfallConfig(), the JAX augmenter's, and the
    augmenter runs it."""
    assert SnowfallConfig().assembly == "window"
    assert ts.SnowfallAugmenter.cfg == SnowfallConfig()
    pc, sets, _ = _sorted_scene("fov")
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    calib = load_hdl64_calib()
    aug = ts.SnowfallAugmenter(
        bank, calib, SnowfallConfig(max_points=8192), device="cpu")
    seen = []
    real = ts.snowfall_augment_dense
    monkeypatch.setattr(ts, "snowfall_augment_dense",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    _, out = aug(pc, order=order)
    assert not seen
    assert out.shape[1] == 5 and set(np.unique(out[:, 4])) <= {0., 1., 2.}
    assert all(int(getattr(aug.last_result, c)) == 0 for c in COUNTERS)


def test_window_matches_oracle():
    """The NumPy oracle on the scene of tests/test_snowfall_parity.py:66:
    every per-point mismatch on a decision boundary (the oracle's margins)
    and under 0.2% of points; the stats equal."""
    calib = load_hdl64_calib()
    pc = synthetic_scan(n_azimuth=100, seed=1, calib=calib)
    pc = pc[np.argsort(pc[:, 4], kind="stable")]
    rng = np.random.default_rng(11)
    sets = []
    for _ in range(64):
        ang = rng.uniform(0, 2 * np.pi, 250)
        d = np.sqrt(rng.uniform(0.01, 1, 250)) * 60
        r = rng.uniform(0.005, 0.05, 250)
        sets.append(np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))
    cfg = SnowfallConfig(**WINDOW)
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    beam_deg = float(np.degrees(3e-3))
    stats_o, aug_o = augment_oracle(pc.astype(np.float64), sets, calib, order,
                                    beam_deg, plane=PLANE,
                                    device_semantics=True)
    res, _ = _port_window(pc, bank, order, cfg)
    assert all(int(getattr(res, c)) == 0 for c in COUNTERS)
    n = len(pc)
    got = res.planes.numpy().T[:n]
    eps = dict(peak_tie=1e-4, range_margin=1e-3, int_margin=1e-3,
               bin_margin=1e-4, min_ratio=1e-5, cull=1e-3, tangency=1e-5,
               angle=1e-6)
    beam_rad = np.radians(beam_deg)
    mismatches, unexplained = 0, []
    for channel in range(64):
        m = pc[:, 4] == channel
        if not m.any():
            continue
        cpc = pc[m].astype(np.float64)
        d = np.linalg.norm(cpc[:, :3], axis=1)
        center = _wrap_02pi(np.arctan2(cpc[:, 1], cpc[:, 0]))
        beams = np.column_stack([_wrap_02pi(center - beam_rad / 2),
                                 _wrap_02pi(center + beam_rad / 2)])
        occl = occlusion_dicts(beams, d, sets[order[channel]], beam_deg)
        lut = (float(calib.min_intensity[channel]),
               float(calib.focal_distance[channel]),
               float(calib.focal_slope[channel]))
        _, want = resimulate_channel(cpc, occl, channel, *lut)
        have = got[m]
        bad = np.nonzero(
            (have[:, 4] != want[:, 4])
            | (np.abs(have[:, 3] - np.round(want[:, 3])) > 1)
            | (np.abs(have[:, :3] - want[:, :3]).max(axis=1) > 0.05))[0]
        for j in bad:
            mismatches += 1
            margins = pulse_decision_margins(d[j], cpc[j, 3], occl[j],
                                             channel, *lut)
            margins.update(hit_set_margins(cpc[j, :3], d[j], beams[j, 0],
                                           beams[j, 1], sets[order[channel]]))
            if not any(margins[k] < e for k, e in eps.items()):
                unexplained.append((channel, int(j)))
    assert not unexplained, unexplained[:5]
    assert mismatches / n < 0.002
    assert (int(res.num_attenuated), int(res.num_removed)) == stats_o[:2]
    assert int(res.avg_intensity_diff) == stats_o[2]
    assert len(got[res.keep.numpy()[:n]]) == len(aug_o)


def test_window_overflow_is_counted_and_not_auto_resolvable():
    """A window narrower than the bank's angular windows counts the
    particles it misses; the augmenter grows nothing for it and raises, as
    the JAX package's does."""
    pc, sets, _ = _sorted_scene("fov")
    cfg = SnowfallConfig(**dict(WINDOW, window_size=4))
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    rj = _jax_window(pc, bank, order, cfg)
    rt, _ = _port_window(pc, bank, order, cfg)
    assert int(rt.window_overflow) == int(rj.window_overflow) > 0
    assert ts.grown_config(cfg, "window_overflow", bank.angle.shape[1],
                           64) is None
    dense = SnowfallConfig(**dict(WINDOW, assembly="dense",
                                  slice_width=128))
    assert ts.grown_config(dense, "window_overflow", bank.angle.shape[1],
                           64).slice_width == 256
    aug = ts.SnowfallAugmenter(bank, load_hdl64_calib(), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="not auto-resolvable"):
        aug(pc, order=order)


@pytest.mark.parametrize("k,b,fires", [(1, 1, "occluder_overflow"),
                                       (2, 1, "bump_overflow")])
def test_occluder_and_bump_overflows_grow_to_the_comfortable_result(
        k, b, fires):
    """Starved max_occluders or max_bumps are counted like the JAX
    package's, and the augmenter grows them to the comfortable output."""
    pc, sets, cfg = _sorted_scene("fov")
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    tight = dataclasses.replace(cfg, max_occluders=k, max_bumps=b)
    rj = _jax_window(pc, bank, order, tight)
    rt, _ = _port_window(pc, bank, order, tight)
    for c in COUNTERS:
        assert int(getattr(rt, c)) == int(getattr(rj, c)), c
    assert int(getattr(rt, fires)) > 0
    calib = load_hdl64_calib()
    grown = ts.SnowfallAugmenter(bank, calib, tight, device="cpu")
    ok = ts.SnowfallAugmenter(bank, calib, cfg, device="cpu")
    s1, o1 = grown(pc, order=order)
    s2, o2 = ok(pc, order=order)
    assert (grown.cfg.max_occluders, grown.cfg.max_bumps) > (k, b)
    assert s1 == s2
    np.testing.assert_array_equal(o1, o2)


def test_batched_searchsorted_matches_numpy():
    """The bisection equals np.searchsorted(side='left') on every row,
    targets below, between, on and above the values included."""
    rng = np.random.default_rng(0)
    rows = np.sort(rng.uniform(-4, 4, (5, 37)).astype(np.float32), axis=1)
    row = rng.integers(0, 5, 400)
    tgt = rng.uniform(-5, 5, 400).astype(np.float32)
    tgt[:20] = rows[row[:20], rng.integers(0, 37, 20)]
    got = ts._batched_searchsorted(torch.as_tensor(rows),
                                   torch.as_tensor(row),
                                   torch.as_tensor(tgt), 37).numpy()
    want = np.array([np.searchsorted(rows[r], t, side="left")
                     for r, t in zip(row, tgt)])
    inside = tgt <= rows[row, -1]
    np.testing.assert_array_equal(got[inside], want[inside])
    assert (got[~inside] >= 37).all()


def test_bank_views_equal_the_bank_arrays():
    """BankTensors' data, angle and wide views equal the ParticleBank's
    arrays bit for bit."""
    _, sets, _ = _scene("fov")
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    bt = ts.bank_to_torch(bank, "cpu")
    for name in ("data", "angle", "wide"):
        got = getattr(bt, name).contiguous().numpy()
        assert got.tobytes() == getattr(bank, name).tobytes(), name


@pytest.fixture(scope="module")
def window_batch():
    """2 frames of the "fov" scene (unsorted, so the channel sort shows),
    the second with the reversed channel order, the JAX package's PRNG keys
    and the port's RANSAC draws made from them (test_torch_snowfall._batch),
    and the JAX `batched_step` on a window config."""
    from lidar_snow_sim_tpu.parallel.batched import (
        batched_step as jax_batched_step,
    )

    pc, sets, _, points, mask, orders, keys, draws = _batch("fov")
    cfg = SnowfallConfig(**WINDOW)
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    want = jax.device_get(jax.jit(
        jax_batched_step, static_argnames=("snow_cfg", "wet_cfg"),
    )(
        jnp.asarray(points), jnp.asarray(mask),
        jax.device_put(JaxParticleBank(*bank)),
        calib_device_arrays(load_hdl64_calib()),
        jnp.asarray(orders, jnp.int32), keys,
        JaxSnowfallConfig(**dataclasses.asdict(cfg)), None,
    )[0])
    return pc, sets, bank, cfg, points, mask, orders, draws, want


def _frame(res, f):
    """Frame f of a batched result, as numpy arrays in a namespace."""
    return types.SimpleNamespace(**{
        name: np.asarray(getattr(res, name))[f] for name in res._fields})


def test_window_batched_step_matches_jax(window_batch):
    """The port's batched_step on a window config against the JAX
    package's, frame by frame, on the JAX draws: rows stable-sorted by
    channel with the padding last, under the parity contract with equal
    counters."""
    from lidar_snow_sim_tpu_torch.parallel.batched import batched_step

    pc, sets, bank, cfg, points, mask, orders, draws, want = window_batch
    calib = load_hdl64_calib()
    got, wet = batched_step(
        torch.as_tensor(points), torch.as_tensor(mask),
        ts.bank_to_torch(bank, "cpu"), ts.calib_to_torch(calib, "cpu"),
        torch.as_tensor(orders), (torch.as_tensor(draws), None), cfg)
    assert wet is None
    srt = pc[np.argsort(pc[:, 4], kind="stable")]
    n = len(pc)
    padded = pad_cloud(srt, cfg.max_points)
    pts, msk = torch.as_tensor(padded.points), torch.as_tensor(padded.mask)
    for f in range(2):
        rt = ts.SnowfallResult(*(x[f] for x in got))
        assert all(int(getattr(rt, c)) == 0 for c in COUNTERS)
        labels = rt.planes[4, :n].numpy()
        assert (labels > 0).sum() > 10
        # non-snow rows keep their input xyz, in the channel-sorted order
        still = labels == 0
        np.testing.assert_array_equal(rt.planes[:3, :n].numpy()[:, still],
                                      srt[still, :3].T)
        assert not rt.keep[n:].any()
        noise_at = ts._plane_and_noise(
            pts[:, :3], pts[:, 3], msk, tgeo.norm3(pts[:, :3]),
            torch.as_tensor(draws[f]), cfg, None).numpy()
        _assert_parity(srt, sets, orders[f], _frame(want, f), rt, noise_at)
    assert not torch.equal(got.planes[0], got.planes[1])


def test_window_datagen_packed_step_matches_batched_step(window_batch,
                                                         monkeypatch):
    """datagen_packed_step on a window config, its frames seeded so that
    their draws are the JAX draws of the test above: the kept rows,
    compacted to the front and packed, equal the batched_step's byte for
    byte, and its counters the JAX batched_step's."""
    from lidar_snow_sim_tpu_torch.parallel import batched

    pc, sets, bank, cfg, points, mask, orders, draws, want = window_batch
    monkeypatch.setattr(
        batched, "frame_draws",
        lambda seed, snow_cfg, wet_cfg: (torch.as_tensor(draws[seed]), None))
    calib = load_hdl64_calib()
    bank_t, calib_t = ts.bank_to_torch(bank, "cpu"), ts.calib_to_torch(
        calib, "cpu")
    n = len(pc)
    meta = np.zeros((2, batched.IN_META_WIDTH), np.int32)
    meta[:, 0] = n
    meta[:, 2] = [0, 1]          # frame f draws draws[f]
    meta[:, 3:] = orders
    planes_c, out_meta = batched.datagen_packed_step(
        torch.as_tensor(points[:, :, :4]),
        torch.as_tensor(points[:, :, 4]).to(torch.uint8),
        torch.as_tensor(meta), bank_t, calib_t, cfg)
    ref, _ = batched.batched_step(
        torch.as_tensor(points), torch.as_tensor(mask), bank_t, calib_t,
        torch.as_tensor(orders), (torch.as_tensor(draws), None), cfg)
    for f in range(2):
        keep = ref.keep[f]
        rows = ref.planes[f][:, keep]
        k = int(keep.sum())
        assert int(out_meta[f, 0]) == k
        assert torch.equal(planes_c[f, :3, :k], rows[:3])
        packed = planes_c[f, 3, :k].view(torch.int32)
        assert torch.equal(packed >> 2, torch.round(rows[3]).int())
        assert torch.equal(packed & 3, rows[4].int())
        jf = _frame(want, f)
        assert out_meta[f, 1:9].tolist() == [
            int(getattr(jf, name)) for name in (
                "num_attenuated", "num_removed", "avg_intensity_diff",
                *COUNTERS)]
        assert out_meta[f, 9:].tolist() == [0, 0, 0, 0]


def test_window_datagen_runs_and_resumes(tmp_path):
    """run_snowfall_datagen takes a window config: every frame written,
    labels in {0, 1, 2}, nothing grown, and a rerun skips them all."""
    from lidar_snow_sim_tpu_torch.parallel.datagen import run_snowfall_datagen

    pc, sets, cfg = _sorted_scene("fov")
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    scans = {f"f{i}": pc[i::2] for i in range(3)}
    run = lambda: run_snowfall_datagen(   # noqa: E731
        list(scans), scans.__getitem__, tmp_path, bank,
        load_hdl64_calib(), cfg, batch=2, device="cpu")
    stats = run()
    assert (stats.frames_done, stats.capacity_growths) == (3, 0)
    for sid, scan in scans.items():
        out = np.fromfile(tmp_path / f"{sid}.bin", np.float32).reshape(-1, 5)
        assert 0 < len(out) <= len(scan)
        assert set(np.unique(out[:, 4])) <= {0.0, 1.0, 2.0}
    assert run().frames_skipped == 3
