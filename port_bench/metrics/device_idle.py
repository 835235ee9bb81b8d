"""device_idle: the share (%) of the traced window in which the card ran
no kernel, copy or memset (1 - the union of the device records over the
window's length on the host clock). Moves scans_per_s."""


def read(run):
    t = run.trace
    if t is None or not t.names or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
