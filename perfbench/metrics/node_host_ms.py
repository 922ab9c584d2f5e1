"""Node: the node's own host milliseconds per scan, outside its compiled
helpers and its host reads (gating, odometry, scan preparation, pose
publication, the pool's bookkeeping): the program's counters
(scan_ns - entry_ns - sync_ns) / timed_scans over the window's untraced
rest (`perfbench.program`)."""

from perfbench import program

LAYER = "node"
UNIT = "ms/scan"
SOURCE = "program_counter"
MOVES = "scans_per_s"


def read(run):
    return program.ms_per_timed_scan(run, lambda c: c["scan_ns"] - c["entry_ns"] - c["sync_ns"])
