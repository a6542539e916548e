"""Edge-list segment primitives (port of elliptic_gnn_tpu/kernels/segment.py).

The plain references for the framework's sparse primitives (gather/scatter
SpMM, segment softmax): `index_add_` and `scatter_reduce` over an edge list.
Messages flow src -> dst; `dst` are the segment ids.
"""
from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids, num_segments)
    return s / torch.clamp(cnt, min=1.0).reshape((-1,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment maximum; an empty segment holds -inf (the dtype's lowest
    value for integers), as jax.ops.segment_max leaves it."""
    shape = (num_segments,) + tuple(data.shape[1:])
    out = data.new_full(shape, float("-inf") if data.is_floating_point()
                        else torch.iinfo(data.dtype).min)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, reduce="amax", include_self=True)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax over segments (the per-destination
    attention normalization). scores: [E, ...] with the segment dim leading."""
    seg_max = segment_max(scores, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ids = segment_ids.long()
    ex = torch.exp(scores - seg_max[ids])
    denom = segment_sum(ex, ids, num_segments)
    return ex / torch.clamp(denom[ids], min=1e-16)


def spmm_edge_list(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   num_nodes: int, weights: Optional[torch.Tensor] = None,
                   mean: bool = False) -> torch.Tensor:
    """out[d] = sum/mean over incoming edges (s -> d) of w_e * x[s]: the
    edge-parallel SpMM, a gather along src and a segment reduction by dst."""
    msg = x[src.long()]
    if weights is not None:
        msg = msg * weights[:, None]
    if mean:
        return segment_mean(msg, dst, num_nodes)
    return segment_sum(msg, dst, num_nodes)
