"""Compiled entry: host milliseconds per scan inside the node's graph_jit
calls (the key, the copy into the graph's buffers, the replay's launch,
the clone of its outputs): the program's counters entry_ns / timed_scans
over the window's untraced rest (`perfbench.program`)."""

from perfbench import program

LAYER = "compiled entry"
UNIT = "ms/scan"
SOURCE = "program_counter"
MOVES = "scans_per_s"


def read(run):
    return program.ms_per_timed_scan(run, lambda c: c["entry_ns"])
