from .segment import (  # noqa: F401
    segment_sum,
    segment_mean,
    segment_max,
    segment_softmax,
    spmm_edge_list,
)
from .bsda import BsdaGraph, bsda_spmm  # noqa: F401
from .bsda_gat import bsda_gat_aggregate
from .ell import EllGraph, build_ell_graph, ell_gat_aggregate, ell_spmm  # noqa: F401


def spmm(g, x, compute_dtype=None):
    """Aggregation dispatch by encoding, as the JAX package's:
      BsdaGraph -> the CUDA kernel for CUDA tensors (it launches or
                   raises), the plain PyTorch version for CPU tensors;
      EllGraph  -> the ELL gather (kernels/ell.py) on either device, at
                   full precision whatever `compute_dtype` says, as the
                   JAX package runs its ELL path;
      ShardedBsda -> one rank's share over the halo path (the ring
                   exchange, then each shard's tables through the same
                   kernel; parallel/shardmap_step.py);
      RowShardedBsda, RowShardedEll -> one rank's rows under the GSPMD row
                   sharding (the rows all-gathered, then the rank's
                   destination rows: the kernel's rectangular launch, or
                   the ELL gather; parallel/gspmd_step.py)."""
    if isinstance(g, EllGraph):
        return ell_spmm(g, x, compute_dtype=None)
    if not isinstance(g, BsdaGraph):
        from ..parallel import gspmd_step
        from ..parallel.shardmap_step import ShardedBsda, sharded_bsda_spmm

        if isinstance(g, ShardedBsda):
            return sharded_bsda_spmm(g, x, compute_dtype=compute_dtype)
        if isinstance(g, gspmd_step.RowShardedBsda):
            return gspmd_step.row_bsda_spmm(g, x, compute_dtype=compute_dtype)
        if isinstance(g, gspmd_step.RowShardedEll):
            return gspmd_step.row_ell_spmm(g, x)
        raise TypeError(f"no aggregation for {type(g).__name__}")
    if x.is_cuda:
        from .bsda_spmm_cuda import bsda_spmm_cuda

        return bsda_spmm_cuda(g, x, compute_dtype=compute_dtype)
    return bsda_spmm(g, x, compute_dtype=compute_dtype)


def gat_aggregate(g, x_proj, alpha_src, alpha_dst, negative_slope=0.2):
    """GAT attention of one layer by encoding: the masked row softmax of
    the ELL graph, one rank's share of the halo path for a ShardedBsda, one
    rank's rows under the GSPMD row sharding for a RowShardedBsda or
    RowShardedEll (both plain PyTorch, as the JAX package attends in XLA
    there), else the BSDA formulation (kernels/bsda_gat.py; the model takes
    the packed kernels for a BsdaGraph on CUDA before it gets here)."""
    if isinstance(g, EllGraph):
        return ell_gat_aggregate(g, x_proj, alpha_src, alpha_dst, negative_slope)
    if not isinstance(g, BsdaGraph):
        from ..parallel import gspmd_step
        from ..parallel.shardmap_step import ShardedBsda, sharded_gat_attend

        if isinstance(g, ShardedBsda):
            return sharded_gat_attend(g, x_proj, alpha_src, alpha_dst, negative_slope)
        if isinstance(g, (gspmd_step.RowShardedBsda, gspmd_step.RowShardedEll)):
            return gspmd_step.row_gat_attend(g, x_proj, alpha_src, alpha_dst,
                                             negative_slope)
        raise TypeError(f"no attention for {type(g).__name__}")
    return bsda_gat_aggregate(g, x_proj, alpha_src, alpha_dst, negative_slope)
