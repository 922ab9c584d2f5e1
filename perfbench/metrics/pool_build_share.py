"""Node: the share of resamples that built the uniform pool, with its
score rejection, of those that could have: the program's counters 100 *
pool_builds / (pool_builds + pool_skips) over the window's untraced rest,
under the rule of the host-time readers (`perfbench.program`); nothing
where the program has no such counters or the rest held no resample. A
resample skips the pool where no slot can take a pool pose (w_diff 0):
near 0 tracking runs no score round, near 100 every resample does."""

from perfbench import program

LAYER = "node"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "scan_ms_p95"


def read(run):
    # per timed scan, so the scale cancels in the share
    resamples = program.ms_per_timed_scan(
        run, lambda c: c.get("pool_builds", 0) + c.get("pool_skips", 0))
    if not resamples:
        return None
    return 100.0 * program.ms_per_timed_scan(run, lambda c: c["pool_builds"]) / resamples
