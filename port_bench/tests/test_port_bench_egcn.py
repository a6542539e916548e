"""EvolveGCN-O's benchmark pieces: the reference's parameters are the
program's, by name and shape; its epoch's work has the aggregations, the
row products and the weights' evolution, counted by hand; the readers of
the evolution's kernels on a stand-in trace."""
import importlib.util
import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402
from port_bench.reference import egcn_o  # noqa: E402

CONF = harness.load_json("port_bench/configs/egcn_o.json")
CFG = CONF["trainer"]


def test_param_spec_is_the_programs():
    import torch

    from elliptic_gnn_tpu_torch.models import build_model

    model = build_model("egcn_o", 166, CFG, generator=torch.Generator().manual_seed(0))
    mine = {k: tuple(p.shape) for k, p in model.named_parameters()}
    spec = egcn_o.param_spec(CFG, 166)
    assert mine == {name: tuple(shape) for name, shape, _ in spec}
    assert {init[0] for _, _, init in spec} <= {"glorot", "zeros"}


def test_epoch_work():
    n, edges, d, c = 1000, 1200, 166, 256
    work = egcn_o.epoch_work(CFG, n, edges, d)
    kinds = {w.kind for w in work}
    assert kinds == {"spmm", "dense", "evolve"}
    spmm = [w for w in work if w.kind == "spmm"]
    # two layers: training forward, backward, eval forward; self-loops among the nonzeros
    assert len(spmm) == 6 and all(w.flops == 2 * (edges + n) * c for w in spmm)
    evolve = [w for w in work if w.kind == "evolve"]
    assert len(evolve) == 2 * (3 * 49 + 1)
    step = lambda dd, k: 2.0 * k * dd * dd * c  # noqa: E731
    assert sum(w.flops for w in evolve) == 49 * (step(d, 6) * 2 + step(d, 10)
                                                 + step(c, 6) * 2 + step(c, 10))
    dense = [w for w in work if w.kind == "dense"]
    # the rows' products: layer 1 three times (no gradient into the features),
    # layer 2 four times; the classifier's two four times each
    want = 2 * n * (3 * d * c + 4 * c * c + 4 * (c * c + c * 2))
    assert sum(w.flops for w in dense) == want
    assert all(w.precision == "f32" for w in work)


def _reader(name):
    path = os.path.join(ROOT, "port_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Trace:
    def __init__(self, ops):
        self.ops = ops

    def seconds(self, patterns):
        return sum(s for name, s in self.ops.items() if any(p in name for p in patterns))


def test_evolution_readers():
    work = egcn_o.epoch_work(CFG, 1000, 1200, 166)
    least = sum(w.bound_s() for w in work if w.kind == "evolve")
    ops = {"void (anonymous namespace)::egcn_gates_kernel(GatesArgs)": 0.004,
           "void (anonymous namespace)::egcn_update_kernel(UpdateArgs)": 0.004,
           "void bsda_spmm_kernel<...>": 0.5}
    ctx = SimpleNamespace(trace=_Trace(ops), epochs=8, work=work)
    assert _reader("evolve_ms").read(ctx) == pytest.approx(1.0)
    assert _reader("egcn_evolve_roofline").read(ctx) == pytest.approx(100 * least * 8 / 0.008)
    assert "egcn_" in _reader("evolve_ms").KERNELS
    ctx.trace = _Trace({"void bsda_spmm_kernel<...>": 0.5})
    assert _reader("evolve_ms").read(ctx) is None
    assert _reader("egcn_evolve_roofline").read(ctx) is None
