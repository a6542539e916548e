from .bsda import BsdaGraph, bsda_spmm  # noqa: F401
from .bsda_gat import bsda_gat_aggregate
from .ell import EllGraph, ell_gat_aggregate, ell_spmm  # noqa: F401


def spmm(g, x, compute_dtype=None):
    """Aggregation dispatch by encoding, as the JAX package's:
      BsdaGraph -> the CUDA kernel for CUDA tensors (it launches or
                   raises), the plain PyTorch version for CPU tensors;
      EllGraph  -> the ELL gather (kernels/ell.py) on either device, at
                   full precision whatever `compute_dtype` says, as the
                   JAX package runs its ELL path."""
    if isinstance(g, EllGraph):
        return ell_spmm(g, x, compute_dtype=None)
    if x.is_cuda:
        from .bsda_spmm_cuda import bsda_spmm_cuda

        return bsda_spmm_cuda(g, x, compute_dtype=compute_dtype)
    return bsda_spmm(g, x, compute_dtype=compute_dtype)


def gat_aggregate(g, x_proj, alpha_src, alpha_dst, negative_slope=0.2):
    """GAT attention of one layer by encoding: the masked row softmax of
    the ELL graph, else the BSDA formulation (kernels/bsda_gat.py; the
    model takes the packed kernels for a BsdaGraph on CUDA before it gets
    here)."""
    if isinstance(g, EllGraph):
        return ell_gat_aggregate(g, x_proj, alpha_src, alpha_dst, negative_slope)
    return bsda_gat_aggregate(g, x_proj, alpha_src, alpha_dst, negative_slope)
