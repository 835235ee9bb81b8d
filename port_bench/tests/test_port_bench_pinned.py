"""A small CPU run of each cell (`small.py`, a pool of 3, 4 frames
sampled) draws the same pool frames for its comparison and compares the
same numbers, bit for bit, as recorded below. A change to the harness
that should leave the cells' runs as they are (how a cell's inputs,
drivers or comparison are found, say) has to keep these. The window
runs on a clock that moves one second a read, so that it holds the
pool's first two rounds whatever the machine's speed."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import harness
from port_bench.tests.small import small

torch.set_num_threads(1)

PINNED = {
    ("dense-datagen-b8", 7): ([1, 2, 0, 2], {
        "row_mismatch_share": 0.0,
        "keep_mismatch_share": 0.00017349063150589867,
        "stats_gap": 0.007407407407407408}),
    ("dense-datagen-b8", 2 ** 33 + 5): ([1, 0, 2, 1], {
        "row_mismatch_share": 0.0004342916702857639,
        "keep_mismatch_share": 0.0,
        "stats_gap": 0.006993006993006993}),
    ("window-loader", 7): ([1, 2, 0, 2], {
        "row_mismatch_share": 0.0,
        "keep_mismatch_share": 0.00017349063150589867,
        "stats_gap": 0.007407407407407408}),
    ("window-loader", 2 ** 33 + 5): ([1, 0, 2, 1], {
        "row_mismatch_share": 0.0004342916702857639,
        "keep_mismatch_share": 0.0,
        "stats_gap": 0.006993006993006993}),
}


class _Clock:
    """`time` as the harness reads it, with a perf_counter that moves one
    second a read."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 1.0
        return self.t

    time = staticmethod(time.time)


@pytest.mark.parametrize("workload,seed", sorted(PINNED))
def test_a_small_run_samples_and_compares_as_pinned(monkeypatch, workload,
                                                    seed):
    picked = []
    draw = harness._sample

    def sample(units, run_seed, k):
        picks = draw(units, run_seed, k)
        picked.extend(units[u]["frames"][j] for u, j in picks)
        return picks

    monkeypatch.setattr(harness, "time", _Clock())
    monkeypatch.setattr(harness, "_sample", sample)
    spec, config, traffic, cell = small(workload, sample_frames=4)
    config["scan"]["pool"] = 3
    result = harness.run_cell(workload, seed, 10.0, False, spec=spec,
                              config=config, traffic=traffic, cell=cell,
                              device="cpu", t_start=time.time(), workers=1)
    frames, numbers = PINNED[workload, seed]
    assert picked == frames
    assert {k: v["value"] for k, v in result["compared"].items()} == numbers
    assert result["correct"] is True
