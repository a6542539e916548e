"""mfu.epoch.gat: mfu.epoch (mfu.epoch.py) in the cells that report epoch_ms.gat.
Moves epoch_ms.gat."""


def read(ctx):
    return ctx.read("mfu.epoch")
