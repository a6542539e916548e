from .modules import build_model, MODEL_GRAPH_KIND  # noqa: F401
from . import losses  # noqa: F401
