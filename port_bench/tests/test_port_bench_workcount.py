"""The operations and bytes of the roofline and MFU arithmetic, on shapes
counted by hand."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from port_bench import workcount as W  # noqa: E402
from port_bench.reference import gat, sage_resbn  # noqa: E402


def test_spmm():
    w = W.spmm("spmm", rows=10, nnz=30, width=4, elem="bf16", row_scale=True)
    assert w.flops == 2 * 30 * 4
    # x read + out written (2 B each) + 4 B a nonzero + 4 B a row + scale
    assert w.bytes == 2 * 10 * 4 * 2 + 4 * 30 + 4 * 10 + 4 * 10
    assert w.bound_s() == pytest.approx(w.bytes / 3.35e12)


def test_dense():
    w = W.dense("dense", rows=100, d_in=8, d_out=2, precision="bf16")
    assert w.flops == 2 * 100 * 8 * 2
    assert w.bytes == 2 * (100 * 8 + 8 * 2 + 100 * 2)
    assert w.flop_s() == pytest.approx(3200 / 989e12)


def test_attention():
    f = W.attention_fwd("attn_fwd", rows=5, edges=12, heads=2, ch=3)
    # per edge and head: 2 * ch for the weighted sum + 5
    assert f.flops == 12 * 2 * (2 * 3 + 5)
    wdt = 2 * 3 + 2 * 2
    assert f.bytes == 4 * 5 * (wdt + wdt) + 4 * 12 + 4 * 5
    b = W.attention_bwd("attn_bwd", rows=5, edges=12, heads=2, ch=3)
    assert b.flops == 12 * 2 * (4 * 3 + 8)
    assert b.bytes == 4 * 5 * (3 * wdt + 2 * 3) + 4 * 12 + 4 * 5


def test_epoch_work_rec_k8():
    cfg = {"hidden_dim": 64, "layers": 3, "time_embed_dim": 2, "amp": True, "aggregation": "auto"}
    work = sage_resbn.epoch_work(cfg, n=1000, edges=3000, in_dim=166)
    spmm = [w for w in work if w.kind == "spmm"]
    # forward 168, 64, 64 in the training and the eval forward; backward 64, 64
    assert sorted(w.flops / (2 * 3000) for w in spmm) == [64] * 6 + [168] * 2
    dense = [w for w in work if w.kind == "dense"]
    # lin_l and lin_r of 168->64, 64->64 and 64->2, and the 168->64 residual projection
    fwd = 2 * 1000 * (2 * 168 * 64 + 2 * 64 * 64 + 2 * 64 * 2 + 168 * 64)
    assert sum(w.flops for w in dense) == 4 * fwd


def test_epoch_work_gat():
    cfg = {"hidden_dim": 32, "layers": 2, "heads": 4, "amp": True}
    work = gat.epoch_work(cfg, n=100, edges=250, in_dim=167)
    fwd = [w for w in work if w.kind == "attn_fwd"]
    bwd = [w for w in work if w.kind == "attn_bwd"]
    assert len(fwd) == 4 and len(bwd) == 2
    assert fwd[0].flops == 350 * 4 * (2 * 8 + 5)
    assert fwd[1].flops == 350 * 1 * (2 * 2 + 5)
