"""mfu.epoch: the epoch's model FLOPs at the published peaks (dense products
at the bf16 tensor-core peak where the configuration states amp, the rest
at the f32 peak; port_bench/workcount.py), over the traced stretch's epoch
time (its window over its epochs). Moves epoch_ms."""


def read(ctx):
    if ctx.epochs <= 0 or ctx.trace.window_s <= 0:
        return None
    least = sum(w.flop_s() for w in ctx.work)
    return 100.0 * least / (ctx.trace.window_s / ctx.epochs)
