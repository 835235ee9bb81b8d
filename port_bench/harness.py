"""One run of one cell: set-up, the measured window, the comparison and
the result line.

Set-up (counted in setup_s, from the process's start): the port's CUDA
kernels built or loaded (`lidar_snow_sim_tpu_torch/_build/`, inside the
checkout), the inputs made (`port_bench/inputs.py`; the bank from
`port_bench/_cache/`), the traffic's driver built and warmed: every shape
the traffic uses run once, capacities grown as the program grows them.
Then the window: units of work back to back until `seconds` have passed;
a unit counts when its host result is back inside the window. With
`trace`, torch.profiler records the card over the window's first
TRACE_SECONDS (the units that end in them, whole), and the per-layer
metrics are read from that. After the window the program's state is freed and a sample of
the window's frames, drawn from the seed among its first two rounds of
the pool, is held against the plain reference (`port_bench/compare.py`).
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import threading
import time
from typing import NamedTuple

import numpy as np

from port_bench import compare, inputs, spec as specs


TRACE_SECONDS = 10.0   # of a traced window, recorded: ~400k device records


class Context(NamedTuple):
    """What a driver is given: the device, the configuration's and the
    traffic's files, the pool of frames, the bank's particle sets, the
    calibration as the program loads it, and the run's seed."""

    device: object
    config: dict
    traffic: dict
    frames: list
    particle_sets: list
    program_calib: object
    run_seed: int


class Run:
    """What a per-layer metric reads: the trace, the scans and frames of
    the traced units, and each frame's work (`workcount.frame_work`)."""

    def __init__(self, trace, scans_traced, frames_traced, ctx):
        self.trace = trace
        self.scans_traced = scans_traced
        self.frames_traced = frames_traced
        self._ctx = ctx
        self._work = {}

    def work(self, frame: int) -> dict:
        from port_bench.workcount import frame_work

        if frame not in self._work:
            fr = self._ctx.frames[frame]
            self._work[frame] = frame_work(fr.scan, fr.order,
                                           self._ctx.particle_sets,
                                           self._ctx.config["snowfall"])
        return self._work[frame]


def process_start() -> float:
    """The wall-clock time this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unread"


class _SmiSampler:
    """nvidia-smi's utilization.gpu sampled once a second in a thread,
    beside the traced part of a window: a cross-check of device_idle."""

    def __init__(self):
        self.samples, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.wait(1.0):
            self.samples.append(_smi("utilization.gpu"))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def _sample(units, seed: int, k: int):
    """k of the window's frames whose outputs were kept and that did not
    fail, drawn from the seed, distinct pool frames first: [(unit,
    position)]."""
    cands = [(u, j) for u, unit in enumerate(units)
             for j, rows in enumerate(unit["rows"]) if rows is not None]
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x5A])
    cands = [cands[i] for i in rng.permutation(len(cands))]
    seen, first, rest = set(), [], []
    for u, j in cands:
        f = units[u]["frames"][j]
        (rest if f in seen else first).append((u, j))
        seen.add(f)
    return (first + rest)[:k]


def _steadiness(done, ends, seconds) -> str:
    """The window's scans a second in each third, and the quartiles of
    the units' seconds: how steady the window ran."""
    thirds = [0, 0, 0]
    for u, t in zip(done, ends):
        thirds[min(int(3 * t / seconds), 2)] += len(u["frames"])
    dur = np.diff([0.0] + list(ends))
    q = np.percentile(dur, [25, 50, 75]) if len(dur) else [0, 0, 0]
    return (f"thirds scans/s {[round(3 * n / seconds, 3) for n in thirds]} "
            f"unit_s q1 {q[0]:.5f} median {q[1]:.5f} q3 {q[2]:.5f}")


def build_kernels():
    """Build (or find built) and load the port's CUDA sources the cells
    run: kernels A1 and W1 (`occluders.cu`), C1 and W2 (`pulse.cu`)."""
    from concurrent.futures import ThreadPoolExecutor

    from lidar_snow_sim_tpu_torch import _kernels

    names = ("occluders", "pulse")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_kernels.build, names))
    for n in names:
        _kernels.load(n)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             spec: dict, config: dict, traffic: dict, cell: dict, device,
             t_start: float, workers: int | None = None) -> dict:
    """One run of cell `name` on `device`; returns the result object (the
    result line's keys) with, beside it under "_log", the lines for
    standard error."""
    import torch

    from lidar_snow_sim_tpu_torch.calib import load_hdl64_calib

    on_card = torch.device(device).type == "cuda"
    if on_card:
        build_kernels()
    calib = inputs.load_calib()
    sets = inputs.particle_sets(config["bank"])
    frames = inputs.frame_pool(seed, config["scan"], calib)
    ctx = Context(torch.device(device), config, traffic, frames, sets,
                  load_hdl64_calib(), int(seed))
    drv = specs.driver(traffic["kind"]).Driver(ctx)
    drv.warm()
    if on_card:
        torch.cuda.synchronize()
    t_window = time.time()
    setup_s = t_window - t_start

    prof = sampler = None
    if trace:
        from port_bench import trace as tracing

        prof = tracing.start(on_card)
        sampler = _SmiSampler().__enter__() if on_card else None
    done, traced = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    ends, kept = [], 0
    while True:
        unit = drv.unit()
        t = time.perf_counter()
        if prof is not None:
            traced.append(unit)
            if t - t0 >= TRACE_SECONDS or t > deadline:
                if on_card:
                    torch.cuda.synchronize()
                # the traced window ends here: stopping the profiler
                # takes seconds of its own
                traced_s = time.perf_counter() - t0
                if sampler is not None:
                    sampler.__exit__()
                tracing.end(prof)
                stopped, prof = prof, None
        if t > deadline:
            break
        # the sample is drawn from the frames of the first two rounds of
        # the pool: later outputs are dropped, so memory stops growing
        if kept >= 2 * len(frames):
            unit["rows"] = [None] * len(unit["rows"])
        kept += len(unit["frames"])
        done.append(unit)
        ends.append(t - t0)
    tr = None
    if trace:
        tr = tracing.read(stopped, traced_s)
    mem = torch.cuda.max_memory_reserved(ctx.device) if on_card else 0
    row_order = drv.row_order
    drv_growths = drv.growths
    del drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    scans = sum(len(u["frames"]) for u in done)
    failed = sum(u["failed"] for u in done)
    lines = [f"setup_s {setup_s:.4f} window_s {seconds} units {len(done)} "
             f"scans {scans} failed {failed} pool {len(frames)} points "
             f"{min(len(f.scan) for f in frames)}-"
             f"{max(len(f.scan) for f in frames)} growths {drv_growths}",
             _steadiness(done, ends, seconds)]

    metrics = {}
    per_layer = specs.metrics_of(spec, name, "per_layer")
    e2e = specs.metrics_of(spec, name, "end_to_end")
    if not trace:
        lat = [x for u in done for x in u["latencies"]]
        values = {"scans_per_s": scans / seconds, "setup_s": setup_s,
                  "scan_p95_ms": (1e3 * float(np.percentile(lat, 95))
                                  if lat else None)}
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        run = Run(tr, sum(len(u["frames"]) for u in traced),
                  [f for u in traced for f in u["frames"]], ctx)
        for m in per_layer:
            v = specs.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if sampler is not None:
            lines.append(f"nvidia-smi utilization.gpu over the trace: "
                         f"{sampler.samples}")
        lines.append(f"trace records {len(tr.names)} busy_s {tr.busy_s()} "
                     f"window_s {tr.window_s}")

    # the comparison, after the window, with the program's state freed
    picks = _sample(done, seed, int(cell["sample_frames"]))
    samples, jobs = [], []
    for u, j in picks:
        f = done[u]["frames"][j]
        fr = frames[f]
        samples.append({"scan": fr.scan, "rows": done[u]["rows"][j],
                        "stats": done[u]["stats"][j]})
        draws_seed = inputs.draws_seed(traffic, seed, fr)
        jobs.append((fr.scan, fr.order, inputs.ransac_draws(
            draws_seed, config["snowfall"]["ransac_trials"])))
    t_ref = time.time()
    refs = compare.reference_results(
        jobs, sets, calib,
        beam_divergence_deg=config["snowfall"]["beam_divergence_deg"],
        noise_floor=config["snowfall"]["noise_floor"],
        fit_on_sorted=config["snowfall"]["assembly"] == "window",
        workers=workers)
    verdict = compare.judge(samples, refs, cell["limits"], row_order)
    lines.append(f"reference: {verdict['frames']} frames, {verdict['rows']} "
                 f"rows, {verdict['mismatched_rows']} mismatched, "
                 f"{time.time() - t_ref:.1f} s")
    for d in verdict["details"]:
        lines.append(f"frame mismatches {d}")

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device) if on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(mem)}
    result = {"correct": verdict["correct"], "attempted": scans,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in verdict["numbers"].items()}
    for k, (v, lim) in verdict["numbers"].items():
        lines.append(f"compared {k} {v!r} limit {lim!r}")
    result["_log"] = lines
    return result
