"""gat_fwd_roofline: the least time of an epoch's attention forwards
('attn_fwd' work from the graph and the widths, port_bench/workcount.py)
over the profiler device time of the gat_fwd kernel's launches (plain and
gated). Moves epoch_ms."""

KERNELS = ("gat_fwd_kernel",)


def read(ctx):
    t = ctx.trace.seconds(KERNELS)
    least = sum(w.bound_s() for w in ctx.work if w.kind == "attn_fwd")
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least * ctx.epochs / t
