"""Node: host reads of device values per scan over the window
(`utils.numerics.SYNCS`)."""

LAYER = "node"
UNIT = "syncs/scan"
SOURCE = "program_counter"
MOVES = "scans_per_s"


def read(run):
    return run.counts["syncs"] / len(run.latencies) if run.latencies else None
