"""w2_roofline: kernel W2's share (%) of its roofline: the least time
the card could take for the pulse phase's work of a frame
(port_bench/workcount.py), over the mean time of a `w2_kernel` record
in the traced window. Moves scans_per_s."""

from port_bench.workcount import roofline_share


def read(run):
    return roofline_share(run, "w2_kernel", "pulse")
