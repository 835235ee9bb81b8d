"""The port's dense snowfall slice against the JAX package.

Both packages run the dense assembly on the same scan, bank, channel order
and injected ground plane; the JAX package runs its Pallas branch in
interpret mode (`use_pallas=True, pallas_interpret=True`), whose slice
geometry, and so whose overflow counters, the port keeps.

Phase A runs on each of the port's three kernels: A1 (the default), A2
(`route_band`) and A3 (`band_width`), each against the JAX package's
branch of the same configuration, and inside the port all three give the
same output bit for bit (tests/test_dense_assembly.py:109).

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

from lidar_snow_sim_tpu.config import SnowfallConfig as JaxSnowfallConfig
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
from lidar_snow_sim_tpu.sampling.banks import ParticleBank as JaxParticleBank
from lidar_snow_sim_tpu_torch import (
    SnowfallConfig,
    build_bank,
    load_hdl64_calib,
    pad_cloud,
    synthetic_scan,
)
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


def _jax_cfg(cfg):
    """The JAX package's config of the port's `cfg`, on its interpreted
    Pallas branch."""
    return dataclasses.replace(
        JaxSnowfallConfig(**dataclasses.asdict(cfg)), use_pallas=True,
        pallas_interpret=True,
    )


def _run_jax(pc, bank, order, cfg):
    calib = load_hdl64_calib()
    padded = pad_cloud(pc, cfg.max_points)
    return jax.device_get(jax.jit(snowfall_augment, static_argnames=("cfg",))(
        jnp.asarray(padded.points), jnp.asarray(padded.mask),
        jax.device_put(JaxParticleBank(*bank)), calib_device_arrays(calib),
        jnp.asarray(order, jnp.int32), jax.random.PRNGKey(0), _jax_cfg(cfg),
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


def _kernel_of(pc, bank, order, cfg):
    """The phase-A kernel the port's layout picks for `cfg`."""
    padded = pad_cloud(pc, cfg.max_points)
    plane = (torch.tensor(PLANE[0], dtype=torch.float32),
             torch.tensor(PLANE[1], dtype=torch.float32))
    return ts.dense_layout(
        torch.as_tensor(padded.points), torch.as_tensor(padded.mask),
        ts.bank_to_torch(bank, "cpu"), torch.as_tensor(order), None, cfg,
        plane=plane,
    ).kernel


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


@pytest.mark.parametrize("starved", [False, True])
@pytest.mark.parametrize("change,kernel", [
    (dict(), "A1"),
    (dict(pallas_pair=True), "A4b"),
    (dict(pallas_transposed=True), "A4a"),
])
def test_clipped_slice_matches_jax(change, kernel, starved):
    """A slice wider than the bank row against the JAX package, which takes
    its XLA dense branch there (k_ext < slice_width + 128). The port's
    clipped slice, on A1 or on A4b / A4a under their knobs, is the whole
    row up to one wrap period, which is the XLA branch's slice: every
    counter is equal and the output meets the parity contract. Starved
    capacities fire the occluder, channel and compact counters with the
    XLA branch's counts."""
    pc, sets, base = _scene("fov")
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    assert bank.angle.shape[1] < 2048
    order = np.random.default_rng(3).permutation(64)
    cfg = SnowfallConfig(**dict(base, slice_width=2048, **change))
    if starved:
        cfg = dataclasses.replace(
            cfg, channel_capacity=64, compact_capacity=64, pulse_chunk=64,
            touch_capacity=16, scatter_capacity=16, max_occluders=1,
            max_bumps=1)
    assert _kernel_of(pc, bank, order, cfg) == kernel
    rj = _run_jax(pc, bank, order, cfg)
    rt, noise_at = _run_port(pc, bank, order, cfg)
    got = {c: int(getattr(rt, c)) for c in COUNTERS}
    assert got == {c: int(getattr(rj, c)) for c in COUNTERS}
    if starved:
        for c in ("occluder_overflow", "channel_overflow",
                  "compact_overflow"):
            assert got[c] > 0, c
        return
    assert (rt.planes[4, :len(pc)].numpy() > 0).sum() > 10
    _assert_parity(pc, sets, order, rj, rt, noise_at)


@pytest.mark.parametrize("starve,fires", [
    (dict(slice_width=8), "window_overflow"),
    (dict(max_occluders=1, max_bumps=1), "occluder_overflow"),
    # routing on (a 136-column slice holds a 128-wide band)
    (dict(slice_width=8, route_band=128, band_group=8), "window_overflow"),
    # banding on, with bands too narrow to cover
    (dict(band_width=32, band_group=8), "window_overflow"),
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
    assert _kernel_of(pc, bank, order, cfg) == (
        "A3" if cfg.band_width else "A2" if cfg.route_band else "A1")
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
    ok = ts.SnowfallAugmenter(bank, calib, SnowfallConfig(**base),
                              device="cpu")
    tight = ts.SnowfallAugmenter(bank, calib, SnowfallConfig(**dict(
        base, channel_capacity=32, slice_width=64, max_occluders=1,
        max_bumps=1, compact_capacity=256, pulse_chunk=256,
    )), device="cpu")
    stats_ok, out_ok = ok(pc, order=order)
    stats_t, out_t = tight(pc, order=order)
    assert tight.cfg.channel_capacity > 32
    assert tight.cfg.max_occluders > 1
    assert stats_t == stats_ok
    np.testing.assert_array_equal(out_t, out_ok)
    assert all(int(getattr(tight.last_result, c)) == 0 for c in COUNTERS)
    assert set(np.unique(out_t[:, 4])) <= {0.0, 1.0, 2.0}


@pytest.mark.parametrize("change", [dict(assembly="window")])
def test_unported_paths_raise(change):
    pc, sets, base = _scene("fov")
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.SnowfallAugmenter(bank, load_hdl64_calib(),
                             SnowfallConfig(**dict(base, **change)),
                             device="cpu")


# (scene, config change, kernel): A2 at three band widths, one not a
# multiple of 128, and on the seam scenes; A3 needs a slice of at least two
# bands, so its case widens the slice to 384 (+128)
GROUPED = [
    ("fov", dict(route_band=256, band_group=8), "A2"),
    ("fov", dict(route_band=128, band_group=8), "A2"),
    ("fov", dict(route_band=96, band_group=8), "A2"),
    ("360", dict(route_band=128, band_group=8), "A2"),
    ("seam", dict(route_band=128, band_group=8), "A2"),
    ("fov", dict(band_width=256, band_group=8, slice_width=384), "A3"),
]


@pytest.mark.parametrize("scene,change,kernel", GROUPED)
def test_grouped_phase_a_matches_jax(scene, change, kernel):
    """The routed (A2) and banded (A3) slices against the JAX package's
    routed and banded Pallas branches."""
    pc, sets, base = _scene(scene)
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    cfg = SnowfallConfig(**dict(base, **change))
    assert _kernel_of(pc, bank, order, cfg) == kernel
    rj = _run_jax(pc, bank, order, cfg)
    rt, noise_at = _run_port(pc, bank, order, cfg)
    assert all(int(getattr(rt, c)) == 0 for c in COUNTERS)
    assert (rt.planes[4, :len(pc)].numpy() > 0).sum() > 10
    _assert_parity(pc, sets, order, rj, rt, noise_at)


@pytest.mark.parametrize("scene", ["fov", "360", "seam"])
def test_routed_and_banded_equal_a1(scene):
    """Inside the port, A1, A2 and A3 give the same slice output bit for
    bit."""
    pc, sets, base = _scene(scene)
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    base = dict(base, slice_width=384, band_group=8)
    out = {}
    for kernel, change in (("A1", {}), ("A2", dict(route_band=128)),
                           ("A3", dict(band_width=256))):
        cfg = SnowfallConfig(**dict(base, **change))
        assert _kernel_of(pc, bank, order, cfg) == kernel
        out[kernel], _ = _run_port(pc, bank, order, cfg)
    for kernel in ("A2", "A3"):
        for name, a, b in zip(ts.SnowfallResult._fields, out["A1"],
                              out[kernel]):
            assert torch.equal(a, b), (kernel, name)


def _three_channel_window(pc, mid=10, gsz=8):
    """The scan with channel `mid` cut to 3 points and channel mid - 1 cut
    so that those 3 sorted rows sit inside one gsz-aligned window between
    rows of channels mid - 1 and mid + 1."""
    ch = pc[:, 4].astype(int)
    keep = np.ones(len(pc), bool)
    keep[np.where(ch == mid)[0][3:]] = False
    drop = ((ch < mid).sum() - 3) % gsz
    keep[np.where(ch == mid - 1)[0][:drop]] = False
    return pc[keep]


def test_three_channel_window_falls_back_like_jax():
    """A channel of fewer than band_group rows in the middle of an aligned
    window matches neither of the window's channel hypotheses: its group
    bounds fall back to -1e9 / 1e9, which widens its slice to the whole
    bank row, and window_overflow counts what the slice misses, as the JAX
    package does. A1 (exact chunk bounds) sees no overflow there."""
    pc, sets, base = _scene("fov")
    pc = _three_channel_window(pc)
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    gsz, blk = 8, base["block_points"]

    # the group bounds of channel 10's window
    ch = torch.as_tensor(pc[:, 4]).long()
    xy = torch.as_tensor(pc[:, :2])
    s_key, perm = torch.sort(ch * 8.0 + torch.atan2(xy[:, 1], xy[:, 0]),
                             stable=True)
    n_pad = -(-len(pc) // blk) * blk
    s_key = torch.nn.functional.pad(s_key, (0, n_pad - len(pc)), value=1e9)
    sx, sy = (torch.nn.functional.pad(xy[perm, i], (0, n_pad - len(pc)))
              for i in (0, 1))
    start = int((ch < 10).sum())
    assert start % gsz == 3 and int((ch == 10).sum()) == 3
    w0_raw = torch.tensor([start // blk * blk] * 3)
    lo, hi = ts.group_az_bounds(sx, sy, s_key, w0_raw,
                                torch.tensor([9, 10, 11]), gsz, blk // gsz)
    g = start % blk // gsz
    assert (float(lo[1, g]), float(hi[1, g])) == (-1e9, 1e9)
    assert abs(float(lo[0, g])) < 4 and abs(float(hi[2, g])) < 4

    for change in (dict(route_band=128, slice_width=128),
                   dict(band_width=128, slice_width=128)):
        cfg = SnowfallConfig(**dict(base, band_group=gsz, **change))
        assert _kernel_of(pc, bank, order, cfg) == (
            "A3" if cfg.band_width else "A2")
        rj = _run_jax(pc, bank, order, cfg)
        rt, _ = _run_port(pc, bank, order, cfg)
        got = int(rt.window_overflow)
        assert got == int(rj.window_overflow) and got > 0, change
    a1, _ = _run_port(pc, bank, order,
                      SnowfallConfig(**dict(base, slice_width=128)))
    assert int(a1.window_overflow) == 0


def test_band_width_grows_to_the_comfortable_result():
    """A band too narrow to cover grows (with the slice) until
    window_overflow is 0; the output equals a comfortably sized run. (Here
    the slice outgrows this small bank's row on the way, and the JAX
    package and the port then leave the banded kernel for A1's layout.)"""
    pc, sets, base = _scene("fov")
    calib = load_hdl64_calib()
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    ok = ts.SnowfallAugmenter(bank, calib, SnowfallConfig(**base),
                              device="cpu")
    cfg = SnowfallConfig(**dict(base, band_width=32, band_group=8))
    assert _kernel_of(pc, bank, order, cfg) == "A3"
    tight = ts.SnowfallAugmenter(bank, calib, cfg, device="cpu")
    stats_ok, out_ok = ok(pc, order=order)
    stats_t, out_t = tight(pc, order=order)
    assert tight.cfg.band_width > 32
    assert stats_t == stats_ok
    np.testing.assert_array_equal(out_t, out_ok)
    assert all(int(getattr(tight.last_result, c)) == 0 for c in COUNTERS)


@pytest.mark.parametrize("cfg,name,want", [
    (dict(band_width=256, slice_width=256), "window_overflow",
     dict(band_width=512, slice_width=512)),
    # the band stops at the row's largest 128 multiple, the slice at k_ext
    (dict(band_width=512, slice_width=700), "window_overflow",
     dict(band_width=768, slice_width=812)),
    (dict(band_width=768, slice_width=812), "window_overflow", None),
    (dict(route_band=384, slice_width=512), "window_overflow",
     dict(route_band=384, slice_width=812)),
])
def test_grown_config_band_width(cfg, name, want):
    """grown_config's window_overflow branch (models/snowfall.py:1363-1374):
    band_width doubles up to (k_ext // 128) * 128, slice_width up to k_ext;
    None when neither can grow."""
    got = ts.grown_config(SnowfallConfig(**cfg), name, 812, 64)
    if want is None:
        assert got is None
    else:
        assert {k: getattr(got, k) for k in want} == want


# ---- the batched step and the knobs that pick A4a, A4b, C2 and the fold

KNOBS = ["batch_fold", "pallas_pair", "pallas_transposed", "pulse_pair"]


def _batch(scene):
    """2 frames of one scene, the second with the reversed channel order
    (tests/test_dense_assembly.py:310): points, mask, orders, the JAX
    package's PRNG keys and the port's RANSAC draws made from them (the
    JAX batched step's own split, parallel/batched.py:36, and uniforms,
    ops/fitting.py:217)."""
    pc, sets, base = _scene(scene)
    padded = pad_cloud(pc, base["max_points"])
    order = np.random.default_rng(3).permutation(64)
    orders = np.stack([order, order[::-1]])
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    trials = SnowfallConfig().ransac_trials
    draws = np.stack([
        np.asarray(jax.random.uniform(jax.random.split(k)[0], (trials, 3)))
        for k in keys
    ])
    return (pc, sets, base, np.stack([padded.points] * 2),
            np.stack([padded.mask] * 2), orders, keys, draws)


def _port_batched(batch, cfg):
    from lidar_snow_sim_tpu_torch.parallel.batched import batched_step

    pc, sets, _, points, mask, orders, _, draws = batch
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    snow, wet = batched_step(
        torch.as_tensor(points), torch.as_tensor(mask),
        ts.bank_to_torch(bank, "cpu"),
        ts.calib_to_torch(load_hdl64_calib(), "cpu"),
        torch.as_tensor(orders), (torch.as_tensor(draws), None), cfg,
    )
    assert wet is None
    return snow


@pytest.fixture(scope="module")
def fov_batch():
    return _batch("fov")


@pytest.fixture(scope="module")
def fov_batched_default(fov_batch):
    return _port_batched(fov_batch, SnowfallConfig(**fov_batch[2]))


@pytest.mark.parametrize("knob", KNOBS)
def test_batched_step_matches_jax(fov_batch, knob):
    """The port's batched_step with each knob against the JAX package's
    batched_step (vmapped snowfall, Pallas interpreted) with the same knob,
    on the JAX draws: labels, keep flags and all five counters equal frame
    by frame."""
    from lidar_snow_sim_tpu.parallel.batched import (
        batched_step as jax_batched_step,
    )

    pc, sets, base, points, mask, orders, keys, _ = fov_batch
    cfg = SnowfallConfig(**dict(base, **{knob: True}))
    got = _port_batched(fov_batch, cfg)
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    want = jax.device_get(jax.jit(
        jax_batched_step, static_argnames=("snow_cfg", "wet_cfg"),
    )(
        jnp.asarray(points), jnp.asarray(mask),
        jax.device_put(JaxParticleBank(*bank)),
        calib_device_arrays(load_hdl64_calib()),
        jnp.asarray(orders, jnp.int32), keys, _jax_cfg(cfg), None,
    )[0])
    n = len(pc)
    for f in range(2):
        for name in COUNTERS:
            assert int(getattr(got, name)[f]) == \
                int(getattr(want, name)[f]) == 0, (f, name)
        np.testing.assert_array_equal(got.planes[f, 4, :n].numpy(),
                                      np.asarray(want.planes)[f, 4, :n])
        np.testing.assert_array_equal(got.keep[f, :n].numpy(),
                                      np.asarray(want.keep)[f, :n])
        assert (got.planes[f, 4, :n].numpy() > 0).sum() > 10
    assert not torch.equal(got.planes[0], got.planes[1])


@pytest.mark.parametrize("knobs", [
    dict(batch_fold=True), dict(pallas_pair=True),
    dict(pallas_transposed=True), dict(pulse_pair=True),
    dict(batch_fold=True, pallas_transposed=True, pulse_pair=True),
])
def test_batched_knobs_equal_the_default(fov_batch, fov_batched_default,
                                         knobs):
    """Inside the port every knob gives the default's output byte for
    byte."""
    got = _port_batched(fov_batch, SnowfallConfig(**dict(fov_batch[2],
                                                         **knobs)))
    for name, a, b in zip(ts.SnowfallResult._fields, got,
                          fov_batched_default):
        assert torch.equal(a, b), name


# (config change, phase-A kernel): the JAX precedence A3 > A2 > A4b > A4a
# > A1 (models/snowfall.py:702-716)
PRECEDENCE = [
    (dict(), "A1"),
    (dict(pallas_transposed=True), "A4a"),
    (dict(pallas_pair=True), "A4b"),
    (dict(pallas_pair=True, pallas_transposed=True), "A4b"),
    (dict(route_band=128, pallas_pair=True, pallas_transposed=True), "A2"),
    (dict(band_width=128, route_band=128, pallas_pair=True), "A3"),
]


@pytest.mark.parametrize("change,kernel", PRECEDENCE)
def test_dense_layout_kernel_precedence(change, kernel):
    pc, sets, base = _scene("fov")
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(64)
    cfg = SnowfallConfig(**dict(base, slice_width=384, band_group=8,
                                **change))
    assert _kernel_of(pc, bank, order, cfg) == kernel


def test_odd_counts_take_a1_and_c1():
    """An odd chunk count (a 63-channel order) takes A1 under pallas_pair,
    even with pallas_transposed set; an odd pulse-block count takes C1 under
    pulse_pair; the outputs equal the default's."""
    pc, sets, base = _scene("fov")
    pc = pc[pc[:, 4] < 63]
    bank = build_bank(sets, window_size=256, wide_capacity=64)
    order = np.random.default_rng(3).permutation(63)
    base = dict(base, compact_capacity=1536, pulse_chunk=512)
    out = {}
    for name, change in (("default", {}),
                         ("pair", dict(pallas_pair=True,
                                       pallas_transposed=True)),
                         ("pulse_pair", dict(pulse_pair=True))):
        cfg = SnowfallConfig(**dict(base, **change))
        padded = pad_cloud(pc, cfg.max_points)
        plane = (torch.tensor(PLANE[0], dtype=torch.float32),
                 torch.tensor(PLANE[1], dtype=torch.float32))
        lay = ts.dense_layout(
            torch.as_tensor(padded.points), torch.as_tensor(padded.mask),
            ts.bank_to_torch(bank, "cpu"), torch.as_tensor(order), None, cfg,
            plane=plane)
        assert lay.n_chunks % 2 == 1 and lay.kernel == "A1"
        comp = ts.compact_occluded(lay, *ts.run_phase_a(lay)[:2],
                                   ts.calib_to_torch(load_hdl64_calib(),
                                                     "cpu"), cfg)
        assert comp.cap // 512 == 3 and comp.pulse_kernel == "C1"
        out[name], _ = _run_port(pc, bank, order, cfg)
    even = dataclasses.replace(cfg, compact_capacity=2048)
    lay = ts.dense_layout(
        torch.as_tensor(padded.points), torch.as_tensor(padded.mask),
        ts.bank_to_torch(bank, "cpu"), torch.as_tensor(order), None, even,
        plane=plane)
    assert ts.compact_occluded(
        lay, *ts.run_phase_a(lay)[:2],
        ts.calib_to_torch(load_hdl64_calib(), "cpu"), even,
    ).pulse_kernel == "C2"
    for name in ("pair", "pulse_pair"):
        for field, a, b in zip(ts.SnowfallResult._fields, out["default"],
                               out[name]):
            assert torch.equal(a, b), (name, field)
