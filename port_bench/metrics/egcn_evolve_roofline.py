"""egcn_evolve_roofline: the least time of an epoch's weight evolution
('evolve' work from the widths and the snapshots, reference/egcn_o.py:
every step of the training forward, the backward and the eval forward)
over the profiler device time of the egcn_evolve kernels' launches in it.
Moves epoch_ms."""

KERNELS = ("egcn_",)


def read(ctx):
    t = ctx.trace.seconds(KERNELS)
    least = sum(w.bound_s() for w in ctx.work if w.kind == "evolve")
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least * ctx.epochs / t
