"""Device: the share of the traced window in which no activity ran on the
card, 1 - busy / window, in percent."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "scans_per_s"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    busy = run.trace.busy_s()
    return 100.0 * (1.0 - busy / run.trace.window_s) if busy > 0 else None
