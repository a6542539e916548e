from .segment import (  # noqa: F401
    segment_sum,
    segment_mean,
    segment_max,
    segment_softmax,
    spmm_edge_list,
)
from .bsda import BsdaGraph, bsda_spmm  # noqa: F401
from .ell import EllGraph, build_ell_graph, ell_gat_aggregate, ell_spmm  # noqa: F401


def spmm(g, x, compute_dtype=None):
    """Aggregation of x's rows by the encoding g picks (GraphEncoding.spmm)."""
    return g.spmm(x, compute_dtype)


def launch_counts(reset: bool = False) -> dict:
    """Every kernel binding's `launches` counter, merged by kernel name (a
    launch counts when its Python runs: at a CUDA graph's capture, not at
    its replays); `reset` zeroes them after the read."""
    from . import bsda_spmm_cuda, egcn_evolve, ell_spmm_cuda, gat_cuda, resbn_epilogue

    bindings = (bsda_spmm_cuda, gat_cuda, resbn_epilogue, egcn_evolve, ell_spmm_cuda)
    counts = {k: v for b in bindings for k, v in b.launches.items()}
    for b in bindings if reset else ():
        b.launches.update(dict.fromkeys(b.launches, 0))
    return counts
