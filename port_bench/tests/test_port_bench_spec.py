"""BENCHMARK.json against the contract's character rules; every file the
harness finds by name is there; a cell added by new files and an entry
alone runs; the import check compares whole top-level names."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import spec as specs

SPEC = specs.load_spec()


def test_names_units_and_lines_use_the_allowed_characters():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [w["config"] for w in SPEC["workloads"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    for n in names:
        assert specs.NAME.fullmatch(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert specs.UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    lines = ([c["why"] for c in SPEC["configs"]]
             + [c["source"] for c in SPEC["configs"]]
             + [w["why"] for w in SPEC["workloads"]]
             + [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"])
    for line in lines:
        assert 1 <= len(line) <= 200 and "\n" not in line and "\t" not in line
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    # no two metrics, cells or configurations share a name
    for group in (SPEC["configs"], SPEC["workloads"],
                  SPEC["end_to_end"] + SPEC["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for w in SPEC["workloads"]:
        got = {m["name"] for m in specs.metrics_of(SPEC, w["name"],
                                                   "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert specs.metrics_of(SPEC, w["name"], "per_layer")


def test_each_cell_finds_its_files_by_name():
    for w in SPEC["workloads"]:
        config = specs.config(SPEC, w["config"])
        assert {"snowfall", "bank", "scan", "precision"} <= set(config)
        traffic = specs.traffic(w["traffic"])
        assert hasattr(specs.driver(traffic["kind"]), "Driver")
        cell = specs.cell(w["name"])
        assert set(cell["limits"]) == {"row_mismatch_share",
                                      "keep_mismatch_share", "stats_gap"}
        for m in specs.metrics_of(SPEC, w["name"], "per_layer"):
            assert callable(specs.metric_reader(m["name"]))
    for c in SPEC["configs"]:
        assert (specs.CHECKOUT / c["file"]).is_file()
        assert c["file"].startswith("port_bench/")


def test_the_import_check_compares_whole_top_level_names():
    assert specs.forbidden_modules([
        "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
        "lidar_snow_sim_tpu", "lidar_snow_sim_tpu.models.snowfall",
        "lidar_snow_sim_tpu_torch", "lidar_snow_sim_tpu_torch.ops",
        "jaxtyping", "flaxen", "numpy"]) == sorted([
            "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "lidar_snow_sim_tpu", "lidar_snow_sim_tpu.models.snowfall"])


def _copy_bench(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(specs.ROOT, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(specs.SPEC, root / "BENCHMARK.json")
    return root


def test_an_added_cell_needs_only_new_files_and_an_entry(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added
    as files and BENCHMARK.json entries to a copy of the benchmark, run
    end to end on the CPU with no file of the copy changed."""
    root = _copy_bench(tmp_path)
    (root / "lidar_snow_sim_tpu_torch").symlink_to(
        specs.CHECKOUT / "lidar_snow_sim_tpu_torch")
    bench = root / "port_bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs"
                      / "inspect-window-gunn2.5.json").read_text())
    cfg["snowfall"].update(max_points=4096, point_chunk=2048)
    cfg["bank"].update(R_0=20.0)
    cfg["scan"].update(pool=2, n_azimuth=50)
    (bench / "configs" / "tiny-window.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny-loader.json").write_text(json.dumps(
        {"kind": "loader", "draws": "run"}))
    (bench / "cells" / "tiny-window-loader.json").write_text(json.dumps(
        {"sample_frames": 1,
         "limits": {"row_mismatch_share": 0.005,
                    "keep_mismatch_share": 0.02, "stats_gap": 0.3}}))
    (bench / "metrics" / "frames_traced.py").write_text(
        "def read(run):\n    return float(len(run.frames_traced))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-window", "source": "test",
                            "file": "port_bench/configs/tiny-window.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-window-loader",
                              "config": "tiny-window",
                              "traffic": "tiny-loader", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames",
                              "better": "higher", "source": "program_counter",
                              "layer": "test", "moves": "scans_per_s",
                              "workloads": ["tiny-window-loader"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json, time, torch; torch.set_num_threads(1)\n"
        "from port_bench import harness, spec as s\n"
        "sp = s.load_spec(); w = s.workload(sp, 'tiny-window-loader')\n"
        "r = harness.run_cell(w['name'], 5, 6.0, True, spec=sp,\n"
        "    config=s.config(sp, w['config']),\n"
        "    traffic=s.traffic(w['traffic']),\n"
        "    cell=s.cell(w['name']), device='cpu', t_start=time.time(),\n"
        "    workers=1)\n"
        "r.pop('_log'); print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["frames_traced"]["value"] >= 1
    after = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()
             and "_cache" not in p.parts and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())


def test_a_checkout_without_the_port_exits_without_a_result(tmp_path):
    root = _copy_bench(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "window-loader", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_run_exits_without_a_result_where_no_card_is(workload):
    """Without a CUDA device the run prints nothing on standard output
    and exits non-zero (this machine's card, where it has one, is hidden
    from the run)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", workload,
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=specs.CHECKOUT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
