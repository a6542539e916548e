from .mesh import NODE_AXIS, Mesh, make_mesh, psum  # noqa: F401
from .sharded import pad_to_multiple, shard_graph_inputs  # noqa: F401
