"""Node: the share of the uniform pool's stop tests, each read one round
late, whose flag had not reached the host when read, so that the host
waited on the card: the program's counters 100 * pool_stalls / pool_tests
over the window's untraced rest, under the rule of the host-time readers
(`perfbench.program`); nothing where the program has no such counters or
the rest held no test. Near 0 the host sets a round's pace, near 100 the
card does."""

from perfbench import program

LAYER = "node"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "scan_ms_p95"


def read(run):
    # per timed scan, so the scale cancels in the share
    tests = program.ms_per_timed_scan(run, lambda c: c.get("pool_tests", 0))
    if not tests:
        return None
    return 100.0 * program.ms_per_timed_scan(run, lambda c: c["pool_stalls"]) / tests
