"""glue_ms: profiler device time an epoch of every device operation that no
per-layer reader of the cell claims as a hand-written kernel or an
aggregation op (the KERNELS of the readers the cell lists): the model's
GEMMs, BatchNorm, casts, dropout, the loss, Adam, the validation PR-AUC, and
the BSDA spill's gathers and index_add_. Moves epoch_ms."""


def read(ctx):
    t = ctx.trace.total_s - ctx.trace.seconds(ctx.claimed)
    if ctx.epochs <= 0 or t <= 0:
        return None
    return 1e3 * t / ctx.epochs
