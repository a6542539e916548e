"""The interface of a graph encoding: each one (BsdaGraph and EllGraph here;
ShardedBsda, RowShardedBsda and RowShardedEll in parallel/) picks its own
aggregation and attention, so the layers above ask it and never test its type."""
from __future__ import annotations


class GraphEncoding:
    def spmm(self, x, compute_dtype=None):
        """x's rows aggregated, in x's dtype; computed in `compute_dtype`
        (bf16 under amp) where the encoding honours it."""
        raise NotImplementedError

    def gat_attend(self, x_proj, alpha_src, alpha_dst, negative_slope=0.2):
        """One GAT layer's attention in plain PyTorch (autograd): x_proj
        [rows, H, Ch], alpha_src/alpha_dst [rows, H] -> [rows, H, Ch]."""
        raise NotImplementedError

    def packed_gat_route(self):
        """(rows, attend(payload, h, ch, slope) -> [ val | m | s ] of those
        rows) where GAT can run packed (kernels/packed_gat.py), else None."""
        return None

    def gat_runs_packed(self, x) -> bool:
        return self.packed_gat_route() is not None
