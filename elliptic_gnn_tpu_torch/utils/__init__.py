from . import common, metrics  # noqa: F401
