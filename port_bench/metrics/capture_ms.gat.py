"""capture_ms.gat: capture_ms (capture_ms.py) in the cells that report epoch_ms.gat.
Moves epoch_ms.gat."""


def read(ctx):
    return ctx.read("capture_ms")
