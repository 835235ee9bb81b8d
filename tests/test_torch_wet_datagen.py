"""The port's wet ground against the JAX package, and the port's datagen
loop, CLI and reference API on tiny synthetic frames.

Wet ground compares like the snowfall slice: the ground set, keep flags and
bail-out agree except on decision boundaries (fewer than 0.2% of points),
intensities within float32 rounding. The datagen outputs must equal the
port's SnowfallAugmenter on the same channel order and RANSAC draws.
"""

import dataclasses
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.config import WetGroundConfig as JaxWetGroundConfig
from lidar_snow_sim_tpu.models.wet_ground import (
    wet_ground_augment as jax_wet,
)
from lidar_snow_sim_tpu_torch import (
    SnowfallConfig,
    WetGroundConfig,
    build_bank,
    load_hdl64_calib,
    load_velodyne_bin,
    pad_cloud,
    synthetic_scan,
)
from lidar_snow_sim_tpu_torch import api
from lidar_snow_sim_tpu_torch.models.snowfall import SnowfallAugmenter
from lidar_snow_sim_tpu_torch.models.wet_ground import (
    WetGroundAugmenter,
    filter_below_ground,
    wet_ground_augment,
)
from lidar_snow_sim_tpu_torch.parallel.datagen import run_snowfall_datagen
from lidar_snow_sim_tpu_torch.tools import precompute

_W = np.array([0.005, -0.003, -1.0])
PLANE = (_W / np.linalg.norm(_W), -1.55)
CFG = SnowfallConfig(
    max_points=8192, window_size=256, wide_capacity=64, max_occluders=48,
    max_bumps=24, assembly="dense", channel_capacity=128, block_points=32,
    slice_width=256,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are small: one intra-op thread per test worker keeps
    the workers from oversubscribing the cores they share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sets():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(64):
        ang = rng.uniform(0, 2 * np.pi, 300)
        d = np.sqrt(rng.uniform(0.01, 1, 300)) * 60
        r = rng.uniform(0.005, 0.05, 300)
        out.append(np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))
    return out


@pytest.fixture(scope="module")
def bank():
    return build_bank(_sets(), window_size=256, wide_capacity=64)


@pytest.mark.parametrize("replace", [True, False])
@pytest.mark.parametrize("fit", ["plane", "draws"])
def test_wet_ground_matches_jax(fit, replace):
    pc = synthetic_scan(n_azimuth=100, seed=2)
    padded = pad_cloud(pc, 8192)
    planes = np.ascontiguousarray(padded.points.T)
    cfg = WetGroundConfig(replace=replace)
    key = jax.random.PRNGKey(4)
    draws = np.array(jax.random.uniform(key, (cfg.ransac_trials, 3)))
    jplane = tport = None
    if fit == "plane":
        jplane = (jnp.asarray(PLANE[0], jnp.float32), jnp.float32(PLANE[1]))
        tport = (torch.tensor(PLANE[0], dtype=torch.float32),
                 torch.tensor(PLANE[1], dtype=torch.float32))
    rj = jax.device_get(jax.jit(jax_wet, static_argnames=("cfg",))(
        jnp.asarray(planes), jnp.asarray(padded.mask), key,
        JaxWetGroundConfig(**dataclasses.asdict(cfg)), plane=jplane,
    ))
    rt = wet_ground_augment(torch.from_numpy(planes),
                            torch.from_numpy(padded.mask),
                            torch.from_numpy(draws), cfg, plane=tport)
    n = len(pc)
    assert not bool(rj.bailed_out) and not bool(rt.bailed_out)
    off = (
        (np.asarray(rj.keep)[:n] != rt.keep.numpy()[:n])
        | (np.asarray(rj.is_ground)[:n] != rt.is_ground.numpy()[:n])
        | (np.asarray(rj.planes)[4, :n] != rt.planes.numpy()[4, :n])
    )
    assert off.mean() < 0.002, f"{off.sum()} of {n} points differ"
    both = ~off & rt.keep.numpy()[:n]
    np.testing.assert_allclose(rt.planes.numpy()[:, :n][:, both],
                               np.asarray(rj.planes)[:, :n][:, both],
                               rtol=2e-4, atol=1e-3)
    assert abs(int(rt.num_modified) - int(rj.num_modified)) <= off.sum()
    assert abs(int(rt.num_removed) - int(rj.num_removed)) <= off.sum()
    assert int(rt.num_modified) > 100


def test_wet_augmenter_order_and_filter():
    pc = synthetic_scan(n_azimuth=100, seed=2)
    out = WetGroundAugmenter(max_points=8192, device="cpu")(pc, plane=PLANE)
    n_ground = int((out[:, 4] == 1).sum())
    assert 0 < n_ground < len(out) <= len(pc)
    # reference order: non-ground first, surviving ground appended
    assert (out[-n_ground:, 4] == 1).all() and (out[:-n_ground, 4] == 0).all()
    kept = filter_below_ground(pc, PLANE[0], PLANE[1])
    assert 0 < len(kept) < len(pc)


def _frame_args(seed, sid):
    r = np.random.default_rng([seed, zlib.crc32(sid.encode())])
    order = r.permutation(64)
    return order, int(r.integers(2**31))


def test_datagen_resume_manifest_and_equality(tmp_path, bank):
    calib = load_hdl64_calib()
    frames = {f"f{s}": synthetic_scan(n_azimuth=60, seed=s, calib=calib)
              for s in range(3)}
    out = tmp_path / "out"
    stats = run_snowfall_datagen(
        list(frames), frames.__getitem__, out, bank, calib, CFG, batch=2,
        seed=7, device="cpu",
    )
    assert stats.frames_done == 3 and stats.frames_skipped == 0
    manifest = json.loads((out / "_manifest.json").read_text())
    assert manifest["stats"]["frames_done"] == 3
    assert not manifest["wet_ground"]
    for sid, pc in frames.items():
        order, s = _frame_args(7, sid)
        _, want = SnowfallAugmenter(bank, calib, CFG, seed=s,
                                    device="cpu")(pc, order=order)
        np.testing.assert_array_equal(load_velodyne_bin(out / f"{sid}.bin"),
                                      want)
    again = run_snowfall_datagen(
        list(frames), frames.__getitem__, out, bank, calib, CFG, batch=2,
        seed=7, device="cpu",
    )
    assert again.frames_skipped == 3 and again.frames_done == 0


def test_datagen_grows_band_width(tmp_path, bank):
    """Datagen on the banded phase A (kernel A3) with bands too narrow to
    cover: band_width grows and the outputs equal a comfortably sized
    run's."""
    calib = load_hdl64_calib()
    frames = {f"f{s}": synthetic_scan(n_azimuth=60, seed=s, calib=calib)
              for s in range(2)}
    tight = dataclasses.replace(CFG, band_width=32, band_group=8)
    stats = run_snowfall_datagen(
        list(frames), frames.__getitem__, tmp_path / "t", bank, calib, tight,
        batch=2, seed=7, device="cpu",
    )
    run_snowfall_datagen(list(frames), frames.__getitem__, tmp_path / "ok",
                         bank, calib, CFG, batch=2, seed=7, device="cpu")
    assert stats.capacity_growths > 0
    for sid in frames:
        np.testing.assert_array_equal(
            load_velodyne_bin(tmp_path / "t" / f"{sid}.bin"),
            load_velodyne_bin(tmp_path / "ok" / f"{sid}.bin"),
        )


def _bank_files(banks):
    """The test particle sets as the 2.5 mm/h, 1.6 m/s gunn bank files;
    returns (rainfall rate, occupancy)."""
    from lidar_snow_sim_tpu_torch.sampling.distributions import (
        compute_occupancy,
        snowfall_rate_to_rainfall_rate,
    )

    rr = snowfall_rate_to_rainfall_rate(2.5, 1.6)
    occ = compute_occupancy(2.5, 1.6)
    for i, part in enumerate(_sets()):
        np.save(banks / f"gunn_{rr}_{occ}_{i + 1}.npy", part)
    return rr, occ


@pytest.mark.parametrize("flags,want", [
    ([], dict(route_band=0, band_width=0, band_group=8)),
    (["--route-band", "384", "--band-group", "16"],
     dict(route_band=384, band_width=0, band_group=16)),
    (["--band-width", "256"], dict(route_band=0, band_width=256)),
])
def test_precompute_cli_phase_a_flags(tmp_path, monkeypatch, flags, want):
    """The CLI's phase-A flags reach the datagen config."""
    from lidar_snow_sim_tpu_torch.parallel import datagen

    seen = []
    monkeypatch.setattr(datagen, "run_snowfall_datagen",
                        lambda *a, **k: seen.append(a[5]) or
                        datagen.DatagenStats())
    (tmp_path / "banks").mkdir()
    _bank_files(tmp_path / "banks")
    (tmp_path / "split.txt").write_text("d,0\n")
    assert precompute.main([
        "--split", str(tmp_path / "split.txt"),
        "--lidar-dir", str(tmp_path / "lidar"),
        "--bank-dir", str(tmp_path / "banks"), "--modes", "gunn",
        "--rates", "2.5", "--velocities", "1.6", "--device", "cpu", *flags,
    ]) == 0
    assert [{k: getattr(c, k) for k in want} for c in seen] == [want]


def test_precompute_cli_wet(tmp_path):
    """The CLI end to end with --wet: FOV filter, bank files, outputs,
    manifest, then the resume."""
    calib = load_hdl64_calib()
    lidar = tmp_path / "lidar_hdl64_strongest"
    banks = tmp_path / "banks"
    lidar.mkdir()
    banks.mkdir()
    for s in range(2):
        synthetic_scan(n_azimuth=60, seed=s, calib=calib).tofile(
            lidar / f"d_{s}.bin"
        )
    (tmp_path / "split.txt").write_text("d,0\nd,1\n")
    rr, occ = _bank_files(banks)
    argv = [
        "--split", str(tmp_path / "split.txt"), "--lidar-dir", str(lidar),
        "--bank-dir", str(banks), "--out-root", str(tmp_path / "out"),
        "--modes", "gunn", "--rates", "2.5", "--velocities", "1.6",
        "--batch", "2", "--max-points", "8192", "--wet", "--device", "cpu",
    ]
    assert precompute.main(argv) == 0
    out_dir = (tmp_path / "out" / "snowfall_simulation" / "gunn"
               / f"lidar_hdl64_strongest_rainrate_{int(rr)}")
    outs = sorted(out_dir.glob("*.bin"))
    assert [p.name for p in outs] == ["d_0.bin", "d_1.bin"]
    manifest = json.loads((out_dir / "_manifest.json").read_text())
    assert manifest["wet_ground"] and manifest["stats"]["frames_done"] == 2
    for p in outs:
        rows = load_velodyne_bin(p)
        assert len(rows) and np.isfinite(rows).all()
        assert set(np.unique(rows[:, 4])) <= {0.0, 1.0, 2.0}
    assert precompute.main(argv) == 0
    rerun = json.loads((out_dir / "_manifest.json").read_text())
    assert rerun["stats"]["frames_skipped"] == 2


def test_api_contracts(tmp_path):
    prefix = "gunn_test"
    for i, part in enumerate(_sets()):
        np.save(tmp_path / f"{prefix}_{i + 1}.npy", part)
    pc = synthetic_scan(n_azimuth=60, seed=3)
    stats, aug = api.augment(pc, prefix, beam_divergence=0.1719,
                             root_path=str(tmp_path), device="cpu")
    assert len(stats) == 3 and all(isinstance(v, int) for v in stats)
    assert aug.shape[1] == 5 and len(aug) <= len(pc)
    assert set(np.unique(aug[:, 4])) <= {0.0, 1.0, 2.0}
    wet = api.ground_water_augmentation(pc, device="cpu")
    assert wet.shape[1] == 5 and len(wet) <= len(pc)


@pytest.mark.parametrize("config", [
    dict(route_band=128, band_group=8),
    dict(band_width=128, band_group=8),
])
def test_api_takes_a_phase_a_config(tmp_path, config):
    """api.augment runs a routed or banded config; its output equals the
    default config's."""
    prefix = "gunn_test"
    for i, part in enumerate(_sets()):
        np.save(tmp_path / f"{prefix}_{i + 1}.npy", part)
    pc = synthetic_scan(n_azimuth=60, seed=3)
    kw = dict(beam_divergence=0.1719, root_path=str(tmp_path), device="cpu",
              shuffle=False)
    want = api.augment(pc, prefix, **kw)
    got = api.augment(pc, prefix, config=config, **kw)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("fold", [True, False])
def test_datagen_packed_step_folds_phase_a(bank, monkeypatch, fold):
    """With batch_fold the packed step runs phase A once per batch (here
    the plain version on CPU tensors, counted), else once per frame; the
    outputs are the same."""
    from lidar_snow_sim_tpu_torch.models.snowfall import (
        bank_to_torch,
        calib_to_torch,
    )
    from lidar_snow_sim_tpu_torch.ops import occluders
    from lidar_snow_sim_tpu_torch.parallel.batched import datagen_packed_step

    calls = []
    plain = occluders.occluders_plain
    monkeypatch.setattr(occluders, "occluders_plain",
                        lambda *a, **k: calls.append(a[2].shape[0])
                        or plain(*a, **k))
    calib = load_hdl64_calib()
    pts = np.zeros((3, CFG.max_points, 4), np.float32)
    chan = np.zeros((3, CFG.max_points), np.uint8)
    meta = np.zeros((3, 67), np.int32)
    for f in range(3):
        pc = synthetic_scan(n_azimuth=60, seed=f, calib=calib)
        pts[f, :len(pc)], chan[f, :len(pc)] = pc[:, :4], pc[:, 4]
        order, s = _frame_args(7, f"f{f}")
        meta[f, 0], meta[f, 2], meta[f, 3:] = len(pc), s, order
    args = (torch.from_numpy(pts), torch.from_numpy(chan),
            torch.from_numpy(meta), bank_to_torch(bank, "cpu"),
            calib_to_torch(calib, "cpu"))
    got = datagen_packed_step(*args, dataclasses.replace(CFG,
                                                         batch_fold=fold))
    n_chunks = calls[0] // (3 if fold else 1)
    assert calls == ([3 * n_chunks] if fold else [n_chunks] * 3)
    calls.clear()
    want = datagen_packed_step(*args, CFG)
    assert len(calls) == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_datagen_keeps_the_knobs_through_growth(tmp_path, bank, monkeypatch):
    """run_snowfall_datagen hands the knobs to the batched step unchanged,
    also after a capacity grew, and writes the default config's files."""
    from lidar_snow_sim_tpu_torch.parallel import datagen

    seen = []
    step = datagen.datagen_packed_step
    monkeypatch.setattr(datagen, "datagen_packed_step",
                        lambda *a, **k: seen.append(a[5]) or step(*a, **k))
    calib = load_hdl64_calib()
    frames = {f"f{s}": synthetic_scan(n_azimuth=60, seed=s, calib=calib)
              for s in range(2)}
    knobs = dict(batch_fold=True, pallas_pair=True, pulse_pair=True)
    tight = dataclasses.replace(CFG, max_occluders=1, max_bumps=1, **knobs)
    stats = run_snowfall_datagen(list(frames), frames.__getitem__,
                                 tmp_path / "k", bank, calib, tight, batch=2,
                                 seed=7, device="cpu")
    run_snowfall_datagen(list(frames), frames.__getitem__, tmp_path / "d",
                         bank, calib, CFG, batch=2, seed=7, device="cpu")
    assert stats.capacity_growths > 0 and len(seen) > 2
    assert all(all(getattr(c, k) for k in knobs) for c in seen[:-1])
    assert seen[-2].max_occluders > 1
    for sid in frames:
        np.testing.assert_array_equal(
            load_velodyne_bin(tmp_path / "k" / f"{sid}.bin"),
            load_velodyne_bin(tmp_path / "d" / f"{sid}.bin"),
        )
