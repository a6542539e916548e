"""glue_ms.gat: glue_ms (glue_ms.py) in the cells that report epoch_ms.gat.
Moves epoch_ms.gat."""


def read(ctx):
    return ctx.read("glue_ms")
