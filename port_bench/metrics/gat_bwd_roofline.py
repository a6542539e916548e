"""gat_bwd_roofline: the least time of an epoch's attention backwards
('attn_bwd' work, port_bench/workcount.py) over the profiler device time of
the backward kernels' launches: gat_bwd (one sweep), or gat_bwd_dst and
gat_bwd_src (two sweeps) where they launch. Moves epoch_ms."""

KERNELS = ("gat_bwd_kernel", "gat_bwd_dst_kernel", "gat_bwd_src_kernel")


def read(ctx):
    t = ctx.trace.seconds(KERNELS)
    least = sum(w.bound_s() for w in ctx.work if w.kind == "attn_bwd")
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least * ctx.epochs / t
