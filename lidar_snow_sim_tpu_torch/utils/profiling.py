"""Tracing, stage timers and throughput counters (counterpart of
`lidar_snow_sim_tpu/utils/profiling.py`).

`StageProfiler` is the JAX package's, copied: per-stage wall timers and
named throughput counters (scans/s, points/s). `device_trace` and
`annotate` are built on `torch.profiler`: the trace holds the CPU's
activity and, where there is a card, the card's kernels, and is written as
a Chrome trace (Perfetto, chrome://tracing). Where the JAX version gives up
silently when tracing fails, this one raises.

Usage:
    prof = StageProfiler()
    with prof.stage("augment"):
        out = step(batch)
        torch.cuda.synchronize()
    prof.count("scans", batch_size)
    print(prof.report())

    with device_trace("/tmp/trace"):
        with annotate("augment"):
            step(batch)
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path


class StageProfiler:
    """Accumulating wall-clock stage timers + named throughput counters."""

    def __init__(self):
        self.times = defaultdict(float)
        self.calls = defaultdict(int)
        self.counters = defaultdict(float)
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield self
        finally:
            self.times[name] += time.perf_counter() - t
            self.calls[name] += 1

    def count(self, name: str, inc: float = 1.0):
        self.counters[name] += inc

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def rate(self, name: str, per_stage: str | None = None) -> float:
        """counter / (stage time | total elapsed) — e.g. scans/sec."""
        denom = self.times[per_stage] if per_stage else self.elapsed
        return self.counters[name] / max(denom, 1e-12)

    def report(self) -> dict:
        total = self.elapsed
        return {
            "elapsed_s": round(total, 3),
            "stages": {
                k: {
                    "s": round(v, 4),
                    "calls": self.calls[k],
                    "pct": round(100 * v / max(total, 1e-12), 1),
                }
                for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])
            },
            "counters": dict(self.counters),
            "rates_per_s": {
                k: round(v / max(total, 1e-12), 2)
                for k, v in self.counters.items()
            },
        }

    def __str__(self):
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the block, written as a Chrome trace
    `log_dir/trace_<time>.json`: the CPU's activity and, where there is a
    card, the card's. A failure to start, stop or write the trace
    raises."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region inside a traced block (a span on the trace's
    timeline)."""
    import torch

    return torch.profiler.record_function(name)
