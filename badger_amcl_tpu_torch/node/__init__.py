from badger_amcl_tpu_torch.node import messages  # noqa: F401
from badger_amcl_tpu_torch.node.node import Node  # noqa: F401
from badger_amcl_tpu_torch.node.node_2d import Node2D  # noqa: F401
from badger_amcl_tpu_torch.node.transforms import Transform, TransformBuffer  # noqa: F401


def make_node(config, tf_buffer=None, seed: int = 0, device="cuda"):
    """Entry-point selection by map_type (reference node.cpp:160-167): the
    2D node; the 3D node is not ported yet (ROADMAP.md, queue 1, "The 3D
    node")."""
    if config.map_type == 3:
        raise NotImplementedError("the 3D node (map_type 3) is not ported yet: "
                                  "ROADMAP.md, queue 1, 'The 3D node'")
    return Node2D(config, tf_buffer, seed, device)
