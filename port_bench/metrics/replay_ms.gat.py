"""replay_ms.gat: replay_ms (replay_ms.py) in the cells that report epoch_ms.gat.
Moves epoch_ms.gat."""


def read(ctx):
    return ctx.read("replay_ms")
