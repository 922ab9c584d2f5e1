"""Compiled entry: calls into the node's graph_jit helpers per scan over the
window, each one CUDA graph replay on the card (captures inside the
window, which should be none, are logged beside it)."""

LAYER = "compiled entry"
UNIT = "replays/scan"
SOURCE = "program_counter"
MOVES = "scans_per_s"


def read(run):
    if run.device_type != "cuda" or not run.latencies:
        return None
    return run.counts["helper_calls"] / len(run.latencies)
