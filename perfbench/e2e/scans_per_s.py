"""Scans completed over the whole window's time: the closed-loop rate one
robot's stream sustains."""

UNIT = "scans/s"


def read(run):
    return len(run.latencies) / run.window_s if run.latencies else None
