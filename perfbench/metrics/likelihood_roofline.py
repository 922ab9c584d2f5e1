"""Measurement model and kernels: the least time of the traced stretch's
likelihood evaluations on the card over their device time, in percent.

The work of an evaluation of M poses against B beams or points is counted
from shapes, whatever arm or kernel runs it: the poses read once (12
bytes each), one texel an endpoint (the 2D field's 4 bytes, the 3D
table's 1), the M weights written, and OPS_PER_PAIR float32 operations
an endpoint (2D: 12, the repository's count for the planar term sums; 3D:
16, for the point-cloud sums). Its device time is that of the activities
launched from the spans in SPANS: the node's sensor-update and scoring
helpers, whose graphs hold the likelihood and little else."""

from perfbench import peaks

LAYER = "measurement model and kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "scan_ms_p95"
SPANS = ("sensor_update", "score_poses")
OPS_PER_PAIR = {4: 12, 1: 16}  # by texel bytes: the 2D field, the 3D table


def read(run):
    if run.trace is None or not run.work:
        return None
    least = 0.0
    for poses, pairs, texel in run.work:
        nbytes = 12 * poses + texel * pairs + 4 * poses
        least += peaks.least_s(nbytes, OPS_PER_PAIR[texel] * pairs)
    dev = run.trace.device_s(SPANS)
    return 100.0 * least / dev if dev > 0 else None
