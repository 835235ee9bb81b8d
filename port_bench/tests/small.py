"""Small CPU versions of the benchmark's cells for the tests: ~3,000-point
scans, a bank of 64 sets drawn within 20 m, and capacities to match. The
port runs its kernels' plain versions on the CPU."""

from __future__ import annotations

import copy
import time

from port_bench import harness, spec as specs

SMALL_SNOW = {"max_points": 4096, "point_chunk": 2048, "channel_capacity": 128,
              "block_points": 32, "slice_width": 384}
SMALL_BANK = {"R_0": 20.0}
SMALL_SCAN = {"pool": 2, "n_azimuth": 50}


def small(workload: str, batch: int = 2, sample_frames: int = 2):
    """(spec, config, traffic, cell) of `workload` shrunk to the CPU."""
    spec = specs.load_spec()
    wl = specs.workload(spec, workload)
    config = copy.deepcopy(specs.config(spec, wl["config"]))
    config["snowfall"].update(SMALL_SNOW)
    config["bank"].update(SMALL_BANK)
    config["scan"].update(SMALL_SCAN)
    traffic = dict(specs.traffic(wl["traffic"]))
    if "batch" in traffic:
        traffic["batch"] = batch
    cell = dict(specs.cell(workload), sample_frames=sample_frames)
    return spec, config, traffic, cell


def run_small(workload: str, seed: int = 7, seconds: float = 6.0,
              trace: bool = False, cache=None, **kw):
    spec, config, traffic, cell = small(workload, **kw)
    return harness.run_cell(workload, seed, seconds, trace, spec=spec,
                            config=config, traffic=traffic, cell=cell,
                            device="cpu", t_start=time.time(), workers=1)
