"""idle_share.gat: idle_share (idle_share.py) in the cells that report epoch_ms.gat.
Moves epoch_ms.gat."""


def read(ctx):
    return ctx.read("idle_share")
