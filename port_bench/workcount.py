"""Operations and bytes of the work an epoch needs, and the least time the
card could take for it: the arithmetic behind every roofline share and
`mfu.epoch`.

The work is reckoned from the graph and the model's widths, never from
the program's tables or launches, so that a change of encoding cannot
move the yardstick. Bytes count each input read once and each output
written once; a graph operand is a minimal index (CSR: 4 bytes a nonzero
and 4 a row) with 4 bytes a row or an edge for the weights or scales the
operation has.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# power limit of 700 W.
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

ELEM_BYTES = {"bf16": 2, "f32": 4}


@dataclasses.dataclass(frozen=True)
class Work:
    """One operation of an epoch: `kind` names the kind of operation (a
    reader picks its own kinds), `flops` and `bytes` its work, `precision`
    the peak its operations run against."""

    kind: str
    flops: float
    bytes: float
    precision: str

    def bound_s(self) -> float:
        """The least time: the larger of the bytes at the memory peak and
        the operations at the peak of the stated precision."""
        return max(self.bytes / PEAK_BYTES_PER_S,
                   self.flops / PEAK_FLOPS[self.precision])

    def flop_s(self) -> float:
        """The operations alone at the peak of their precision."""
        return self.flops / PEAK_FLOPS[self.precision]


def dense(kind: str, rows: int, d_in: int, d_out: int, precision: str) -> Work:
    """A dense product [rows, d_in] @ [d_in, d_out]."""
    e = ELEM_BYTES["bf16" if precision == "bf16" else "f32"]
    return Work(kind, 2.0 * rows * d_in * d_out,
                e * (rows * d_in + d_in * d_out + rows * d_out), precision)


def spmm(kind: str, rows: int, nnz: int, width: int, elem: str,
         row_scale: bool) -> Work:
    """An aggregation out = A @ x over `nnz` edges into `rows` rows at
    `width` features in `elem` (bf16 or f32 operands, f32 accumulation):
    2 operations a nonzero and feature; x read and out written once, the
    index, and 4 bytes a row where the operation scales its rows."""
    e = ELEM_BYTES[elem]
    nbytes = 2 * rows * width * e + 4 * nnz + 4 * rows + (4 * rows if row_scale else 0)
    return Work(kind, 2.0 * nnz * width, nbytes, "f32")


def attention_fwd(kind: str, rows: int, edges: int, heads: int, ch: int) -> Work:
    """One GAT layer's attention forward over `edges` (self-loops
    included), f32: per edge and head the score (a sum and the LeakyReLU),
    the shift, the exp and its sum, and the weighted sum of `ch` features.
    Reads the projected rows [xp | a_src | a_dst], writes [val | m | s]."""
    w = heads * ch + 2 * heads
    nbytes = 4 * rows * (w + w) + 4 * edges + 4 * rows
    return Work(kind, float(edges) * heads * (2 * ch + 5), nbytes, "f32")


def attention_bwd(kind: str, rows: int, edges: int, heads: int, ch: int) -> Work:
    """Its backward: reads the projected rows, the forward's [val | m | s]
    and the cotangent of val; writes the projected rows' cotangent. Per
    edge and head the score and weight again, the cotangents of the
    weighted sum's features and of the score."""
    w = heads * ch + 2 * heads
    nbytes = 4 * rows * (w + w + heads * ch + w) + 4 * edges + 4 * rows
    return Work(kind, float(edges) * heads * (4 * ch + 8), nbytes, "f32")
