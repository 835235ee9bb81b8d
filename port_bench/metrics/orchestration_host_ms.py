"""orchestration_host_ms: host ms a scan in the snowfall orchestration
(the batched core, the preamble, the window inputs and tail, the dense
layout, compaction and scatter): the self time of those spans over the
traced window, over its scans (`port_bench/spans.py`). Moves
scans_per_s."""

from port_bench.spans import layer_ms


def read(run):
    return layer_ms(run, "orchestration")
