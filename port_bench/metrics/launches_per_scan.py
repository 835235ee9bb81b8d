"""launches_per_scan: the device records (kernels, copies, memsets) of
the traced window over the scans the window handed back. Moves
scans_per_s."""


def read(run):
    t = run.trace
    if t is None or not t.names or not run.scans_traced:
        return None
    return len(t.names) / run.scans_traced
