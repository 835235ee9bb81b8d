"""preamble_host_ms: host ms a scan in the preamble (RANSAC plane,
incident angles, noise floor: `snowfall.plane_noise`), a part of
orchestration_host_ms, over the traced window's scans
(`port_bench/spans.py`). Moves scans_per_s."""

from port_bench.spans import span_ms


def read(run):
    return span_ms(run, "snowfall.plane_noise")
