from .modules import build_model, prepare_graph_ops, MODEL_GRAPH_KIND  # noqa: F401
from . import losses  # noqa: F401
