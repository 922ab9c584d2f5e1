"""Compiled entry: seconds of the process's graph_jit warm-ups and
captures, each a new key's first call: the program's counter capture_ns
(`perfbench.program`)."""

from perfbench import program

LAYER = "compiled entry"
UNIT = "s"
SOURCE = "program_counter"
MOVES = "setup_s"


def read(run):
    return program.seconds(run, "capture_ns")
