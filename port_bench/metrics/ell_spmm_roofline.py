"""ell_spmm_roofline: the least time of an epoch's aggregations ('spmm'
work, counted from the graph and the widths in port_bench/workcount.py)
over the profiler device time of the ELL kernel's launches in it
(csrc/ell_spmm.cu, forward and transpose). Moves epoch_ms."""

KERNELS = ("ell_spmm_kernel",)


def read(ctx):
    t = ctx.trace.seconds(KERNELS)
    least = sum(w.bound_s() for w in ctx.work if w.kind == "spmm")
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least * ctx.epochs / t
