"""host_syncs_per_scan: the host syncs (synchronizing CUDA calls, implicit
ones included) the program made inside its spans over the traced window,
over the scans the window handed back (`port_bench/spans.py`). Moves
scans_per_s."""

from port_bench.spans import host_syncs


def read(run):
    return host_syncs(run)
