"""evolve_ms: profiler device time an epoch of EvolveGCN-O's weight-evolution
kernels (kernels/csrc/egcn_evolve.cu: the forward's gates and update, the
backward's steps, the weights' and biases' gradient sums), matched by the
`egcn_` of their names; claimed, so that glue_ms leaves them out. None
where no such kernel ran. Moves epoch_ms."""

KERNELS = ("egcn_",)


def read(ctx):
    t = ctx.trace.seconds(KERNELS)
    if ctx.epochs <= 0 or t <= 0:
        return None
    return 1e3 * t / ctx.epochs
