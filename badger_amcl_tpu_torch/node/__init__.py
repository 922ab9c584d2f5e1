from badger_amcl_tpu_torch.node import messages  # noqa: F401
from badger_amcl_tpu_torch.node.node import Node  # noqa: F401
from badger_amcl_tpu_torch.node.node_2d import Node2D  # noqa: F401
from badger_amcl_tpu_torch.node.node_3d import Node3D  # noqa: F401
from badger_amcl_tpu_torch.node.transforms import Transform, TransformBuffer  # noqa: F401


def make_node(config, tf_buffer=None, seed: int = 0, device="cuda"):
    """Entry-point selection by map_type (reference node.cpp:160-167)."""
    if config.map_type == 3:
        return Node3D(config, tf_buffer, seed, device)
    return Node2D(config, tf_buffer, seed, device)
