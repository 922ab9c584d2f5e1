"""Filter core: device milliseconds per scan of the node's resample helper
over the traced stretch (systematic resample, KLD count, cluster labels
and statistics, the index_add_ sums), from the activities launched from
the spans in SPANS."""

LAYER = "filter core"
UNIT = "ms/scan"
SOURCE = "device_trace"
MOVES = "scans_per_s"
SPANS = ("resample",)


def read(run):
    if run.trace is None or not run.traced_scans:
        return None
    dev = run.trace.device_s(SPANS)
    return 1e3 * dev / run.traced_scans if dev > 0 else None
