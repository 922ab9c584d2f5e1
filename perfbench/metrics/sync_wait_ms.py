"""Node: host milliseconds per scan spent in the node's host reads of
device values, the host blocked on the device: the program's counters
sync_ns / timed_scans over the window's untraced rest
(`perfbench.program`)."""

from perfbench import program

LAYER = "node"
UNIT = "ms/scan"
SOURCE = "program_counter"
MOVES = "scan_ms_p95"


def read(run):
    return program.ms_per_timed_scan(run, lambda c: c["sync_ns"])
