"""The device trace of a traced run: torch.profiler's CUPTI records of the
kernels, copies and memsets the run's process put on the card in the
traced window, read from the profiler's chrome trace (written to TMPDIR,
summarized, deleted).

`Trace` holds the device records and the window's length; the per-layer
metrics (`port_bench/metrics/`) read it.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """Device records of one traced window: `names` (str per record),
    `start_us` and `end_us` (float arrays, the profiler's clock), and
    `window_s`, the window's length on the host clock."""

    def __init__(self, names, start_us, end_us, window_s: float):
        self.names = list(names)
        self.start_us = np.asarray(start_us, np.float64)
        self.end_us = np.asarray(end_us, np.float64)
        self.window_s = float(window_s)

    def busy_s(self) -> float:
        """Seconds in which some record ran (the union of the records)."""
        if not self.names:
            return 0.0
        order = np.argsort(self.start_us, kind="stable")
        s, e = self.start_us[order], self.end_us[order]
        reach = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > reach[:-1]
        group = np.cumsum(new) - 1
        ends = np.zeros(group[-1] + 1)
        np.maximum.at(ends, group, e)
        return float((ends - s[new]).sum()) / 1e6

    def kernel_us(self, kernel: str):
        """Durations (us) of the records whose name holds `kernel`."""
        pick = np.array([kernel in n for n in self.names], bool)
        return (self.end_us - self.start_us)[pick] if pick.size else pick

    def device_ops(self, top: int = 10):
        """[[name, seconds], ...] of the names that took most time."""
        tot = defaultdict(float)
        for n, d in zip(self.names, self.end_us - self.start_us):
            tot[short_name(n)] += d / 1e6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """[[name, seconds], ...]: idle time between records, summed by
        the pair of device operations around each gap: what the host ran
        between enqueuing the one and the other."""
        if len(self.names) < 2:
            return []
        order = np.argsort(self.start_us, kind="stable")
        s, e = self.start_us[order], self.end_us[order]
        reach = np.maximum.accumulate(e)
        gap = s[1:] - reach[:-1]
        tot = defaultdict(float)
        for i in np.nonzero(gap > 0)[0]:
            key = (f"{short_name(self.names[order[i]])} -> "
                   f"{short_name(self.names[order[i + 1]])}")
            tot[key] += gap[i] / 1e6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]


def short_name(name: str) -> str:
    """A device record's name without its argument list, its return type
    and the `at::native::` prefixes, cut to 100 characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.removeprefix("void ").replace("at::native::", "")
    return name.replace("(anonymous namespace)::", "").strip()[:100]


def start(on_card: bool = True):
    """A running torch.profiler session that records the card's
    activity (kernels, copies, memsets) alone; off the card (the CPU
    tests) the host's, which holds no device record."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA if on_card
                               else ProfilerActivity.CPU])
    prof.__enter__()
    return prof


def end(prof) -> None:
    """End the session."""
    prof.__exit__(None, None, None)


def read(prof, window_s: float) -> Trace:
    """The ended session's device records, as a Trace."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    names, starts, ends = [], [], []
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            names.append(ev["name"])
            starts.append(float(ev["ts"]))
            ends.append(float(ev["ts"]) + float(ev.get("dur", 0.0)))
    return Trace(names, starts, ends, window_s)
