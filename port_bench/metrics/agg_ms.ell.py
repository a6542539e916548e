"""agg_ms.ell: profiler device time an epoch of the ELL aggregation's
gathers (index_select: ATen's vectorized gather) and their index_add_
backward, matched by the names of ATen's index kernels; the weighted sums
between them run as cuBLAS GEMVs and count as glue. Moves epoch_ms."""

KERNELS = ("vectorized_gather_kernel", "indexSelect", "indexFunc")


def read(ctx):
    t = ctx.trace.seconds(KERNELS)
    if ctx.epochs <= 0 or t <= 0:
        return None
    return 1e3 * t / ctx.epochs
