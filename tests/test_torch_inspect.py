"""The port's headless inspector (`lidar_snow_sim_tpu_torch.tools.inspect`)
against the JAX package's on one synthetic scan.

With `--augment none --dror --fov` the two reports must be identical: the
scan is nudged until no point pair lies within 1e-3 m of its DROR radius
boundary (the f32 distance expansion's cancellation can flip such pairs,
models/dror.py), and the test asserts that before comparing. The
augmentations draw from different generators in the two packages (jax.random
and torch), so there the reports must have the same keys, the output labels
lie in {0, 1, 2} and the capacity counters read 0. Snow and snow+wet run
once more with the JAX package's RANSAC draws handed to the port
(`jax_draws`) and numpy's global seed (the channel order) set the same
before each package's run: both packages' rows, in the JAX CLI's order
(the window assembly's, stable-sorted by channel), and the reports' values
agree under the parity contract of tests/test_snowfall_parity.py (labels,
intensities and kept rows equal but on under 0.2% of points, xyz within
1e-6; the stats equal where no point differs).
"""

import argparse
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax

from lidar_snow_sim_tpu.tools import inspect as jinspect
from lidar_snow_sim_tpu.tools.inspect import main as jax_inspect
from lidar_snow_sim_tpu_torch import (
    compute_occupancy,
    snowfall_rate_to_rainfall_rate,
    synthetic_scan,
)
from lidar_snow_sim_tpu_torch.models.snowfall import OVERFLOW_COUNTERS
from lidar_snow_sim_tpu_torch.ops.lut_lookup import lut_lookup_pairs
from lidar_snow_sim_tpu_torch.tools import inspect as tinspect
from test_weather_baselines import _dror_numpy_counts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boundary_gap(pc):
    """Per point, the smallest |pair distance - DROR radius| over the others
    (f64)."""
    _, d, sr = _dror_numpy_counts(pc)
    gap = np.abs(d - sr[:, None])
    np.fill_diagonal(gap, np.inf)
    return gap.min(axis=1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory, calib):
    """A 60-azimuth synthetic scan (3,513 points), nudged by up to 1 cm
    until its pairs all clear the DROR radius boundary by 2e-3 m, and the
    viewer's default particle files
    (gunn, 0.5 mm/h, 2 m/s): 64 sets of 40 small flakes."""
    tmp = tmp_path_factory.mktemp("inspect")
    pc = synthetic_scan(n_azimuth=60, seed=0, calib=calib)
    rng = np.random.default_rng(0)
    for _ in range(50):
        bad = np.nonzero(_boundary_gap(pc) < 2e-3)[0]
        if not len(bad):
            break
        pc[bad, :3] += rng.uniform(-0.01, 0.01, (len(bad), 3)).astype(
            np.float32)
    else:
        raise AssertionError("the boundary repair did not converge")
    scan = tmp / "scan.bin"
    pc.astype(np.float32).tofile(scan)
    banks = tmp / "banks"
    banks.mkdir()
    rr = snowfall_rate_to_rainfall_rate(0.5, 2.0)
    occ = compute_occupancy(0.5, 2.0)
    for line in range(1, 65):
        ang = rng.uniform(0, 2 * np.pi, 40)
        d = np.sqrt(rng.uniform(0.01, 1, 40)) * 60
        r = rng.uniform(0.005, 0.05, 40)
        np.save(banks / f"gunn_{rr}_{occ}_{line}.npy",
                np.column_stack([d * np.cos(ang), d * np.sin(ang), r]))
    return pc, scan, banks


def _jax_report(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_inspect(argv) == 0
    return json.loads(out.getvalue())


def _port_run(argv):
    """(output cloud, JSON-normalised report) of the port's run_pipeline."""
    ap = tinspect.add_pipeline_args(argparse.ArgumentParser())
    pc, report, _ = tinspect.run_pipeline(ap.parse_args(argv), ap)
    return pc, json.loads(json.dumps(report))


def _keys(report):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in report.items()}


def test_inspect_dror_fov_reports_identical(scene):
    pc, scan, _ = scene
    assert _boundary_gap(pc).min() >= 1e-3
    argv = [str(scan), "--augment", "none", "--dror", "--fov"]
    want = _jax_report(argv)
    _, got = _port_run([*argv, "--device", "cpu"])
    assert got == want
    assert want["dror"]["removed"] > 0 and want["fov_removed"] > 0


@pytest.mark.parametrize("augment", ["lisa", "fog", "stf_fog", "snow+wet"])
def test_inspect_augment_report_matches_jax_keys(scene, augment):
    _, scan, banks = scene
    argv = [str(scan), "--augment", augment, "--bank-dir", str(banks)]
    want = _jax_report(argv)
    n0 = lut_lookup_pairs.launches
    out, got = _port_run([*argv, "--device", "cpu"])
    assert lut_lookup_pairs.launches == n0       # CPU: the plain version
    assert _keys(got) == _keys(want)
    assert out.shape[1] == 5 and np.isfinite(out).all()
    assert set(np.unique(out[:, 4])) <= {0.0, 1.0, 2.0}
    assert got["loaded"] == want["loaded"]
    assert got["after_masks"] == want["after_masks"]
    assert sum(got["labels"].values()) == got["after_masks"]
    if augment == "lisa":
        assert got["lisa"]["droplet_overflow"] == 0
        assert want["lisa"]["droplet_overflow"] == 0
    if augment in ("fog", "stf_fog"):
        stats = got[augment]
        assert stats["num_scattered"] + stats["num_attenuated"] <= len(out)
        assert len(out) == got["after_masks"] - stats["num_removed"]
    if augment == "fog":
        assert got["fog"]["num_removed"] == want["fog"]["num_removed"] == 0
    if augment == "snow+wet":
        snow = next(a for k, a in tinspect._AUGMENTER_CACHE.items()
                    if k[0] == "snow")
        res = snow.last_result
        assert {n: int(getattr(res, n)) for n in OVERFLOW_COUNTERS} == \
            dict.fromkeys(OVERFLOW_COUNTERS, 0)
        assert got["wet"]["points"] == len(out)


def test_inspect_main_prints_report_and_bev(scene, tmp_path, capsys):
    """The CLI entry point: JSON on stdout, the BEV PNG written."""
    _, scan, _ = scene
    bev = tmp_path / "bev.png"
    assert tinspect.main([str(scan), "--augment", "fog", "--device", "cpu",
                          "--bev", str(bev)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["bev"] == str(bev.resolve())
    assert bev.stat().st_size > 0
    assert report["fog"]["num_removed"] == 0


def jax_draws(seed, trials, generator=None):
    """The JAX package's RANSAC uniforms of `seed`: its augmenters fit the
    plane with jax.random.uniform(PRNGKey(seed), (trials, 3))
    (ops/fitting.py:217), where the port draws from a torch generator."""
    return torch.tensor(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), (trials, 3))))


def assert_rows_parity(got, want):
    """Two packages' output rows under the parity contract: the same rows,
    labels and intensities equal on >= 99.8% of them, xyz within 1e-6
    elsewhere; returns the rows that differ."""
    assert got.shape == want.shape
    off = (got[:, 3:] != want[:, 3:]).any(axis=1)
    assert off.mean() < 0.002, f"{off.sum()} of {len(got)} rows differ"
    np.testing.assert_allclose(got[~off, :3], want[~off, :3], rtol=1e-6,
                               atol=1e-6)
    return int(off.sum())


@pytest.mark.parametrize("augment", ["snow", "snow+wet"])
def test_inspect_snow_matches_jax_values(scene, augment, monkeypatch):
    from lidar_snow_sim_tpu_torch.models import snowfall as tsnow
    from lidar_snow_sim_tpu_torch.models import wet_ground as twet

    monkeypatch.setattr(tsnow, "ransac_draws", jax_draws)
    monkeypatch.setattr(twet, "ransac_draws", jax_draws)
    _, scan, banks = scene
    argv = [str(scan), "--augment", augment, "--bank-dir", str(banks),
            "--seed", "5"]
    jap = jinspect.add_pipeline_args(argparse.ArgumentParser())
    np.random.seed(13)
    want, jrep, _ = jinspect.run_pipeline(jap.parse_args(argv), jap)
    jrep = json.loads(json.dumps(jrep))
    np.random.seed(13)
    got, rep = _port_run([*argv, "--device", "cpu"])
    assert (got[:, 4] > 0).sum() > 0          # snow touched the scan
    differ = assert_rows_parity(got, np.asarray(want))
    if not differ:
        assert rep == jrep
    assert rep["snow"]["particle_file_prefix"] == \
        jrep["snow"]["particle_file_prefix"]
