"""boundary_ms.gat: boundary_ms (boundary_ms.py) in the cells that report epoch_ms.gat.
Moves epoch_ms.gat."""


def read(ctx):
    return ctx.read("boundary_ms")
