"""Compiled entry: the share of the tensors that the node's graph_jit
calls moved into and out of their graphs that moved in a transfer of
their dtype group (one copy-in and one clone per dtype, not one per
tensor): the program's counters 100 * entry_grouped / entry_leaves over
the window's untraced rest, under the rule of the host-time readers
(`perfbench.program`); nothing where the program has no such counters or
the rest held no call. A tensor moved alone (a non-contiguous input)
lowers it."""

from perfbench import program

LAYER = "compiled entry"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "scans_per_s"


def read(run):
    # per timed scan, so the scale cancels in the share
    leaves = program.ms_per_timed_scan(run, lambda c: c.get("entry_leaves", 0))
    if not leaves:
        return None
    return 100.0 * program.ms_per_timed_scan(run, lambda c: c["entry_grouped"]) / leaves
