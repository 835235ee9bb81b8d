"""The per-layer metrics read from the program's own spans
(`port_bench/spans.py`): a traced run of each cell at the small CPU size
reports all five, finite and not negative; an untraced run reports none;
each reader gives None where the program recorded no span."""

from __future__ import annotations

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench import spec as specs
from port_bench.harness import Run
from port_bench.tests.small import run_small

torch.set_num_threads(1)

SPAN_METRICS = ("host_syncs_per_scan", "entry_host_ms",
                "orchestration_host_ms", "kernel_calls_host_ms",
                "preamble_host_ms")
WORKLOADS = [w["name"] for w in specs.load_spec()["workloads"]]


def test_the_span_metrics_are_reported_in_every_cell():
    spec = specs.load_spec()
    for w in WORKLOADS:
        names = {m["name"] for m in specs.metrics_of(spec, w, "per_layer")}
        assert set(SPAN_METRICS) <= names, w


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_reports_the_span_metrics(workload):
    result = run_small(workload, trace=True)
    assert result["correct"] is True, result["compared"]
    for name in SPAN_METRICS:
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    m = result["metrics"]
    assert m["orchestration_host_ms"]["value"] > 0
    assert m["kernel_calls_host_ms"]["value"] > 0
    assert m["preamble_host_ms"]["value"] <= m["orchestration_host_ms"][
        "value"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_untraced_run_reports_no_span_metric(workload):
    result = run_small(workload, trace=False, seconds=3.0)
    assert not set(SPAN_METRICS) & set(result["metrics"])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_reader_reads_nothing_without_spans(name):
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    read = specs.metric_reader(name)
    assert read(Run(None, 4, [0, 1, 2, 3], None)) is None
    assert read(Run(None, 0, [], None)) is None
