"""Maps: wall seconds of the node's map receipt (map_msg_received or
octomap_msg_received: the field or voxel table built on the card, the
textures and free cells), up to a synchronise."""

LAYER = "maps"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(run):
    return run.info.get("map_receipt_s")
