"""The port's span-and-counter recorder (elliptic_gnn_tpu_torch/utils/trace.py)
and the spans the trainer opens, on the CPU at a 1,500-node synthetic graph:

  - nesting: each span's parent id is the span open around it, and a
    parent keeps its children's summed durations by name;
  - bounded memory: after 10^5 spans the kept spans stay at the bound, the
    per-name count and total count every span;
  - build_train_state opens `setup.order`, `setup.tables` and
    `setup.model` under `setup.build`, for the BSDA and the ELL encodings;
  - the K loop (K = 4, its body eagerly on the CPU) leaves one `loop.block`
    a block with `loop.launch`, `loop.sync` and `loop.tail` under it; its
    losses are the serial loop's and its loop_info keys as before
    (`boundary_ms`, as `replay_ms`, is CUDA's alone);
  - the clock: under a CPU torch.profiler a span's stamps match its
    `user_annotation` event (`ts` + `baseTimeNanoseconds`) within 1 ms."""
import json

import numpy as np
import pytest
import torch

from elliptic_gnn_tpu_torch.graph import build_graph
from elliptic_gnn_tpu_torch.train import train_gnn
from elliptic_gnn_tpu_torch.utils import trace

from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)


class _Clock:
    """A clock for a Recorder that moves only when told to."""

    def __init__(self):
        self.ns = 1_000_000_000

    def __call__(self):
        return self.ns, self.ns

    def advance(self, ms: float) -> None:
        self.ns += int(ms * 1e6)


class _Rows:
    """The trainer's logger, keeping each epoch's loss."""

    def __init__(self):
        self.loss = []

    def log_epoch(self, epoch, train_loss, val_pr_auc, extras=None):
        self.loss.append(float(train_loss))

    def close(self):
        pass


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    cfg = {"seed": 0, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
           "synthetic": True, "synthetic_nodes": 1500,
           "processed_dir": str(root / "processed"), "data_dir": str(root / "raw")}
    build_graph.main(cfg)
    return cfg["processed_dir"]


def _cfg(processed_dir, **kw):
    cfg = {"run_name": "spans", "seed": 0, "processed_dir": processed_dir,
           "device": "cpu", "arch": "sage_resbn", "hidden_dim": 8, "layers": 2,
           "dropout": 0.2, "lr": 0.02, "weight_decay": 5e-5, "grad_clip": 1.0,
           "max_epochs": 10, "patience": 50, "class_weight_pos": "auto", "amp": False,
           "symmetrize_edges": True, "time_embed_dim": 2, "time_embed_type": "sin",
           "max_timestep": 16, "train_window_k": 8, "resume": False}
    cfg.update(kw)
    return cfg


def test_span_nesting_and_child_totals():
    clock = _Clock()
    rec = trace.Recorder(clock=clock)
    with rec.span("a", x=1) as a:
        clock.advance(1)
        with rec.span("b") as b:
            clock.advance(2)
            with rec.span("c") as c:
                clock.advance(4)
        with rec.span("b") as b2:
            clock.advance(8)
        a.attrs["y"] = 2
    with rec.span("d") as d:
        pass
    assert a.parent is None and d.parent is None
    assert b.parent == a.id and b2.parent == a.id and c.parent == b.id
    assert len({a.id, b.id, b2.id, c.id, d.id}) == 5
    assert a.seconds == pytest.approx(15e-3) and b.seconds == pytest.approx(6e-3)
    assert a.child_seconds("b") == pytest.approx(14e-3) and a.child_seconds("c") is None
    assert b.child_seconds("c") == pytest.approx(4e-3)
    assert a.attrs == {"x": 1, "y": 2}
    assert [s.name for s in rec.spans()] == ["c", "b", "b", "a", "d"]
    assert rec.last("b") is b2 and rec.last("nothing") is None
    assert rec.totals()["b"] == {"count": 2, "seconds": pytest.approx(14e-3)}
    assert rec.count("n") == 1 and rec.count("n", 4) == 5 and rec.counters() == {"n": 5}
    rec.reset()
    assert rec.spans() == [] and rec.counters() == {} and rec.last("a") is None


def test_memory_is_bounded():
    clock = _Clock()
    rec = trace.Recorder(clock=clock)
    for i in range(100_000):
        with rec.span("x" if i % 2 else "y", i=i):
            clock.advance(1e-3 if i % 2 else 2e-3)
    kept = rec.spans()
    assert len(kept) == trace.MAX_SPANS
    assert kept[-1].attrs["i"] == 99_999 and kept[0].attrs["i"] == 100_000 - trace.MAX_SPANS
    assert rec.totals() == {"x": {"count": 50_000, "seconds": pytest.approx(0.05)},
                            "y": {"count": 50_000, "seconds": pytest.approx(0.1)}}
    assert rec.last("x").attrs["i"] == 99_999 and rec.last("y").attrs["i"] == 99_998


@pytest.mark.parametrize("aggregation", ["bsda", "ell"])
def test_setup_spans_nest_under_build(processed, aggregation):
    trace.reset()
    cfg = _cfg(processed, aggregation=aggregation)
    data = train_gnn.prepare_data(cfg)
    train_gnn.build_train_state(cfg, data, 0, torch.device("cpu"))
    build = trace.last("setup.build")
    assert trace.last("setup.prepare").parent is None and build.parent is None
    for name in ("setup.order", "setup.tables", "setup.model"):
        spans = trace.spans(name)
        assert spans and all(s.parent == build.id for s in spans), name
        assert build.child_seconds(name) == pytest.approx(sum(s.seconds for s in spans))
    # ELL's tables are built, relabelled (the order), then uploaded
    assert len(trace.spans("setup.tables")) == (2 if aggregation == "ell" else 1)
    parts = sum(build.child_seconds(n) for n in ("setup.order", "setup.tables", "setup.model"))
    assert parts <= build.seconds


def test_k_loop_spans(processed):
    cfg = _cfg(processed, epochs_per_sync=4)
    cpu = torch.device("cpu")
    runs = {}
    for k in (1, 4):
        data = train_gnn.prepare_data(cfg)
        data, model, gops, opt, loss_fn = train_gnn.build_train_state(cfg, data, 0, cpu)
        inputs = train_gnn._Inputs(data, cpu)
        trace.reset()
        rows = _Rows()
        out = train_gnn._train_loop_fullbatch(dict(cfg, epochs_per_sync=k), None, inputs,
                                              model, gops, opt, loss_fn, rows, cpu)
        runs[k] = rows.loss, out
    np.testing.assert_allclose(runs[4][0], runs[1][0], rtol=0, atol=1e-5)
    _, _, epochs_run, epoch_seconds, info = runs[4][1]
    assert epochs_run == 10 and len(epoch_seconds) == 10
    assert info == {"epochs_per_sync": 4}
    blocks = trace.spans("loop.block")
    assert [(b.attrs["call"], b.attrs["block"], b.attrs["epochs"]) for b in blocks] == \
        [(1, 0, 4), (1, 1, 4), (1, 2, 2)]
    for b in blocks:
        kids = [s for s in trace.spans() if s.parent == b.id]
        assert [s.name for s in kids] == ["loop.launch", "loop.sync", "loop.tail"]
        assert "boundary_ms" not in b.attrs and "replay_ms" not in b.attrs
    assert trace.spans("loop.capture") == [] and trace.counters() == {"loop_calls": 1}


def test_span_stamps_on_the_profiler_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    rec = trace.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("clock.check") as sp:
            torch.ones(64).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        chrome = json.load(fh)
    base = int(chrome.get("baseTimeNanoseconds", 0))
    ev = next(e for e in chrome["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("name") == "clock.check")
    start_ns = base + ev["ts"] * 1e3
    end_ns = start_ns + ev["dur"] * 1e3
    assert abs(sp.start_ns - start_ns) < 1e6 and abs(sp.end_ns - end_ns) < 1e6
