"""entry_host_ms: host ms a scan in the entry points' own work (pad,
growth check and compaction of `SnowfallAugmenter`; draws and packing of
`datagen_packed_step`): their spans' self time over the traced window,
over its scans (`port_bench/spans.py`). Moves scans_per_s."""

from port_bench.spans import layer_ms


def read(run):
    return layer_ms(run, "entry")
