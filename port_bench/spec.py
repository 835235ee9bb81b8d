"""BENCHMARK.json and the files the harness finds by name in it:

- `port_bench/configs/<config>.json`: a configuration (the entry's "file");
- `port_bench/traffic/<traffic>.json`: a traffic mix, whose "kind" names
  its driver, `port_bench/drivers/<kind>.py`;
- `port_bench/cells/<workload>.json`: a cell's comparison: its limits and
  how many frames it samples;
- `port_bench/metrics/<metric>.py`: a per-layer metric's reader.

A cell, a configuration, a traffic mix or a per-layer metric is added by
adding such files and an entry in BENCHMARK.json; no file changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
SPEC = CHECKOUT / "BENCHMARK.json"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_snow_sim_tpu")


def load_spec(path: Path = SPEC) -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return _json(CHECKOUT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(ROOT / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    return _json(ROOT / "cells" / f"{name}.json")


def driver(kind: str):
    return importlib.import_module(f"port_bench.drivers.{kind}")


def metric_reader(name: str):
    """The `read(run)` of `port_bench/metrics/<name>.py`."""
    path = ROOT / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, workload_name: str, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics the workload
    reports: those with no "workloads" key, and those that list it."""
    return [m for m in spec[kind]
            if workload_name in m.get("workloads", [workload_name])]


def forbidden_modules(modules) -> list[str]:
    """The names in `modules` whose top-level name (before the first dot)
    is, whole, one of FORBIDDEN."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)
