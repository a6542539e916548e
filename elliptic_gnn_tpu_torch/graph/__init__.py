from .data import GraphData, load_meta, load_processed, save_processed  # noqa: F401
from .masks import make_temporal_masks  # noqa: F401
