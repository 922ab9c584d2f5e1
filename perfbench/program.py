"""The program's own recorder (`badger_amcl_tpu_torch.utils.profiling`):
its counters and its spans, read in the process that ran the cell, or
None where the program has none (a version without them).

The host-time counters `timed_scans`, `scan_ns`, `entry_ns` and
`sync_ns` cover the program's timed scans since its last profiled one:
in a traced run, the window's untraced rest after the traced stretch,
never the warm-up. Where that rest is shorter than MIN_SCANS (the 2D
cell: the profiler's stop outlasts the window) they read nothing. Spans
are kept only while a profiler runs, so they are the traced stretch's,
on the profiler's host clock in nanoseconds since the epoch.
"""

# the fewest timed scans a per-scan mean is read over: at a resample
# every 7-11 scans, 9 or more resampling scans
MIN_SCANS = 100


def _recorder(name: str):
    try:
        from badger_amcl_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, name, None)
    return None if read is None else read()


def counters():
    """The program's counters ({name: int}), or None."""
    return _recorder("counters")


def spans():
    """The program's kept spans (each with name, start_ns, end_ns), or
    None."""
    return _recorder("spans")


def ms_per_timed_scan(run, ns_of):
    """ns_of(counters) in milliseconds per timed scan, on a card, where
    the timed scans are the window's untraced rest and number MIN_SCANS or
    more; else None."""
    if run.device_type != "cuda":
        return None
    c = counters()
    if not c or "timed_scans" not in c:
        return None
    n = c["timed_scans"]
    if not MIN_SCANS <= n <= len(run.latencies) - run.traced_scans:
        return None
    return 1e-6 * ns_of(c) / n


def seconds(run, key: str):
    """A set-up counter of nanoseconds in seconds, on a card; None on the
    CPU or where it counted nothing."""
    if run.device_type != "cuda":
        return None
    c = counters()
    return 1e-9 * c[key] if c and c.get(key) else None
