"""Seconds from the process's start to the first timed scan: loading,
building the map, raycasting the lap, warming every graph key."""

UNIT = "s"


def read(run):
    return run.setup_s
