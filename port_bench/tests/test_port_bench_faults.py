"""The comparison must fail a broken timed path and pass a sound one: each
cell's run driven on the CPU at a small size (`small.py`), with the
program's entry broken underneath; and the control (the reference in
bfloat16) must read over the cell's limits. The faults a cell can have:
the state returned unchanged (no snow), half of a batch left out
(datagen: the second half of each batch returned unchanged), an answer
altered where it is produced (labels 1 and 2 swapped). One chip: no
exchange between chips to leave out."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lidar_snow_sim_tpu_torch.models.snowfall import SnowfallAugmenter
from lidar_snow_sim_tpu_torch.parallel.batched import datagen_packed_step

from port_bench.control import run_control
from port_bench.drivers import datagen, loader
from port_bench.tests.small import run_small, small

torch.set_num_threads(1)


def _unchanged_planes(points, in_meta, planes, meta, frames):
    """The frames' packed outputs as their inputs: every point kept,
    label 0, the stats 0."""
    for b in frames:
        n = int(in_meta[b, 0])
        planes[b] = 0
        planes[b, :3, :n] = points[b, :n, :3].T
        pk = torch.round(points[b, :n, 3]).to(torch.int32) << 2
        planes[b, 3, :n] = pk.view(torch.float32)
        meta[b, 0] = n
        meta[b, 1:4] = 0
    return planes, meta


def _datagen_fault(kind):
    def step(points, chan, in_meta, *args, **kw):
        planes, meta = datagen_packed_step(points, chan, in_meta, *args, **kw)
        b = points.shape[0]
        if kind == "unchanged":
            return _unchanged_planes(points, in_meta, planes, meta, range(b))
        if kind == "half_batch":
            return _unchanged_planes(points, in_meta, planes, meta,
                                     range(b // 2, b))
        pk = planes[:, 3].view(torch.int32)
        lab = pk & 3
        swapped = torch.where(lab == 1, 2, torch.where(lab == 2, 1, lab))
        planes[:, 3] = ((pk & ~3) | swapped).view(torch.float32)
        return planes, meta
    return step


def _loader_fault(kind):
    class Broken(SnowfallAugmenter):
        def __call__(self, pc, order=None, shuffle=True):
            stats, rows = super().__call__(pc, order=order, shuffle=shuffle)
            if kind == "unchanged":
                rows = pc[np.argsort(pc[:, 4], kind="stable")].copy()
                rows[:, 4] = 0
                return (0, 0, 0), rows
            rows = rows.copy()
            lab = rows[:, 4].copy()
            rows[lab == 1, 4], rows[lab == 2, 4] = 2, 1
            return stats, rows
    return Broken


@pytest.mark.parametrize("workload", ["dense-datagen-b8", "window-loader"])
def test_a_sound_run_is_correct(workload):
    result = run_small(workload)
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_a_broken_datagen_step_is_not_correct(monkeypatch, kind):
    monkeypatch.setattr(datagen, "datagen_packed_step", _datagen_fault(kind))
    result = run_small("dense-datagen-b8")
    assert result["correct"] is False, (kind, result["compared"])


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_a_broken_augmenter_is_not_correct(monkeypatch, kind):
    monkeypatch.setattr(loader, "SnowfallAugmenter", _loader_fault(kind))
    result = run_small("window-loader")
    assert result["correct"] is False, (kind, result["compared"])


@pytest.mark.parametrize("workload", ["dense-datagen-b8", "window-loader"])
def test_the_control_reads_over_the_limits(workload):
    _, config, traffic, cell = small(workload)
    for seed in (1, 2, 3):
        numbers = run_control(seed, config, traffic, 2, workers=1)
        assert any(numbers[k] > lim for k, lim in cell["limits"].items()), (
            seed, numbers)
