"""kernel_calls_host_ms: host ms a scan in the kernel calls (each
wrapper's host work and its launches: W1 and W2, A1, C1): the whole time
of those spans over the traced window, over its scans
(`port_bench/spans.py`). Moves scans_per_s."""

from port_bench.spans import layer_ms


def read(run):
    return layer_ms(run, "kernel_calls")
