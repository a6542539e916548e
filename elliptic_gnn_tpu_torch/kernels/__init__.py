from .bsda import BsdaGraph, bsda_spmm  # noqa: F401


def spmm(g, x, compute_dtype=None):
    """BSDA aggregation: the CUDA kernel for CUDA tensors, the plain
    PyTorch version for CPU tensors."""
    if x.is_cuda:
        from .bsda_spmm_cuda import bsda_spmm_cuda

        return bsda_spmm_cuda(g, x, compute_dtype=compute_dtype)
    return bsda_spmm(g, x, compute_dtype=compute_dtype)
