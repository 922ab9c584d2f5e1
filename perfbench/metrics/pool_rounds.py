"""Node: rounds of the uniform pool's score rejection per resampling scan
(each round a scoring replay, a pool replay and a host read), counted at
the node's calls into its scoring helper while it resamples."""

LAYER = "node"
UNIT = "rounds/resample"
SOURCE = "program_counter"
MOVES = "scan_ms_p95"


def read(run):
    n = run.counts.get("resamples", 0)
    return run.counts["score_rounds"] / n if n else None
