"""The port's card-vs-oracle parity tool (`tools/parity_gpu.py`) on the CPU,
against the JAX package's (`tools/parity_tpu.py`).

The port's tool, asked for the CPU, writes a report with `ok` true and the
oracle's stats (29, 847, 194) on the parity scene. The JAX tool runs on the
CPU as the JAX package's tests run its Pallas kernels: in interpret mode
(its `snowfall_augment` wrapped to set `pallas_interpret=True`). Each
variant's five overflow counters and device stats must equal the JAX
tool's, and both tools classify 0 mismatches on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu.tools import parity_tpu
from lidar_snow_sim_tpu_torch.tools import parity_gpu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("parity") / "PARITY_GPU.json"
    assert parity_gpu.main([str(out), "--device", "cpu"]) == 0
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def jax_report(tmp_path_factory):
    from lidar_snow_sim_tpu.models import snowfall as jsnow

    orig = jsnow.snowfall_augment

    def interpreted(points, mask, bank, calib_arrays, order, key, cfg,
                    plane=None):
        return orig(points, mask, bank, calib_arrays, order, key,
                    dataclasses.replace(cfg, pallas_interpret=True),
                    plane=plane)

    out = tmp_path_factory.mktemp("parity") / "PARITY_TPU.json"
    mp = pytest.MonkeyPatch()
    mp.setattr(jsnow, "snowfall_augment", interpreted)
    try:
        assert parity_tpu.main(str(out)) == 0
    finally:
        mp.undo()
    return json.loads(out.read_text())


def test_port_report_ok(port_report):
    r = port_report
    assert r["ok"] is True
    assert r["backend"] == "cpu" and r["card"] is None
    assert r["torch"] == torch.__version__
    assert r["points"] == 5727
    assert r["oracle_stats"] == dict(num_attenuated=29, num_removed=847,
                                     avg_intensity_diff=194)
    assert list(r["assemblies"]) == ["window", "dense_pallas",
                                     "dense_pallas_routed"]
    for a in r["assemblies"].values():
        assert a["total"] == 5727
        assert a["num_unexplained"] == 0 and a["mismatch_rate"] < 0.002
        assert not any(a["overflows"].values())


def test_port_report_keys_are_the_jax_tools(port_report, jax_report):
    """The JAX tool's keys, each variant's overflows and device stats equal;
    the port adds the card line, the torch version and the launches."""
    assert set(jax_report) <= set(port_report)
    assert set(port_report) - set(jax_report) == {"card", "torch"}
    assert port_report["oracle_stats"] == jax_report["oracle_stats"]
    assert port_report["points"] == jax_report["points"]
    for name, want in jax_report["assemblies"].items():
        got = port_report["assemblies"][name]
        assert set(got) - set(want) == {"launches"}
        assert got["overflows"] == want["overflows"], name
        assert got["device_stats"] == want["device_stats"], name
        assert got["total"] == want["total"]
        assert got["num_mismatches"] == want["num_mismatches"] == 0, name
    assert jax_report["ok"] is True


def test_routed_variant_runs_both_a2_modes():
    """The routed variant's layout mixes full-slice (mode 1) and
    fast-banded (mode 2) groups, so kernel A2 runs both bodies."""
    from lidar_snow_sim_tpu_torch.models import snowfall as ts
    from lidar_snow_sim_tpu_torch.utils.pointcloud import pad_cloud

    calib, pc, sets, bank, order, cfg = parity_gpu.build_scene()
    padded = pad_cloud(pc, cfg.max_points)
    w = np.array([0.005, -0.003, -1.0])
    plane = (torch.tensor(w / np.linalg.norm(w), dtype=torch.float32),
             torch.tensor(-1.55))
    lays = {name: ts.dense_layout(
        torch.as_tensor(padded.points), torch.as_tensor(padded.mask),
        ts.bank_to_torch(bank, "cpu"), torch.as_tensor(order), None, vcfg,
        plane=plane) for name, vcfg in parity_gpu.variants(cfg).items()
        if vcfg.assembly == "dense"}
    assert lays["dense_pallas"].kernel == "A1"
    routed = lays["dense_pallas_routed"]
    assert routed.kernel == "A2"
    modes = torch.bincount(routed.occluder_args[5].long(), minlength=3)
    assert modes[1] > 0 and modes[2] > 0
