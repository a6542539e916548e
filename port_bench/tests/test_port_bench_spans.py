"""The readers of the program's spans (metrics/setup.*_s.py, capture_ms*.py,
boundary_ms*.py) on a recorder filled by hand: each reads the right
number, None from an empty recorder (and the set-up's from a run off the
card), and boundary_ms leaves out the boundaries the traced stretch was on
for."""
import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from elliptic_gnn_tpu_torch.utils import trace  # noqa: E402
from port_bench import harness  # noqa: E402

READERS = ("setup.prepare_s", "setup.order_s", "setup.tables_s", "capture_ms",
           "capture_ms.gat", "boundary_ms", "boundary_ms.gat")


class _Clock:
    def __init__(self):
        self.ns = 5_000_000_000

    def __call__(self):
        return self.ns, self.ns

    def advance(self, ms: float) -> None:
        self.ns += int(round(ms * 1e6))


@pytest.fixture
def rec(monkeypatch):
    """The process's recorder, replaced by one on a clock that moves by
    `advance` alone."""
    clock = _Clock()
    recorder = trace.Recorder(clock=clock)
    monkeypatch.setattr(trace, "RECORDER", recorder)
    return SimpleNamespace(span=recorder.span, advance=clock.advance)


def _read(name, device="cuda"):
    ctx = SimpleNamespace(cfg={"device": device})
    ctx.read = lambda other: harness._reader(other).read(ctx)
    return ctx.read(name)


def _setup(rec, prepare, parts):
    with rec.span("setup.prepare"):
        rec.advance(prepare)
    with rec.span("setup.build"):
        for name, ms in parts:
            with rec.span(name):
                rec.advance(ms)


def _loop_call(rec, blocks, call):
    """One call of the K loop: a capture in its first block, then each
    block's boundary (none for the first) as the trainer records it."""
    for b in range(blocks):
        with rec.span("loop.block", call=call, block=b, epochs=8) as blk:
            if b == 0:
                with rec.span("loop.capture"):
                    rec.advance(100.0 * call)
            else:
                blk.attrs["boundary_ms"] = float(b + 10 * call)
            blk.attrs.update(replays=8, replay_ms=9.0)


@pytest.mark.parametrize("name", READERS)
def test_empty_recorder_reads_none(rec, name):
    assert _read(name) is None


def test_setup_readers(rec):
    _setup(rec, 999.0, [("setup.order", 1.0), ("setup.tables", 1.0), ("setup.model", 1.0)])
    # the run's last set-up; ELL's tables in two parts around the order
    _setup(rec, 250.0, [("setup.tables", 1500.0), ("setup.order", 3000.0),
                        ("setup.tables", 500.0), ("setup.model", 7.0)])
    assert _read("setup.prepare_s") == pytest.approx(0.25)
    assert _read("setup.order_s") == pytest.approx(3.0)
    assert _read("setup.tables_s") == pytest.approx(2.0)
    # a run off the card reports no time
    for name in ("setup.prepare_s", "setup.order_s", "setup.tables_s"):
        assert _read(name, device="cpu") is None


def test_capture_reads_the_last_call(rec):
    _loop_call(rec, 2, call=1)
    _loop_call(rec, 3, call=2)
    assert _read("capture_ms") == pytest.approx(200.0)
    assert _read("capture_ms.gat") == pytest.approx(200.0)


def test_boundary_leaves_out_the_traced_stretch(rec):
    _loop_call(rec, 4, call=1)
    _loop_call(rec, 14, call=2)
    lo, hi = harness.TRACE_FROM_BLOCK, harness.TRACE_FROM_BLOCK + harness.TRACE_BLOCKS
    kept = [b + 20.0 for b in range(1, 14) if not lo <= b <= hi]
    assert kept  # blocks 1..2 and 10..13
    assert _read("boundary_ms") == pytest.approx(sum(kept) / len(kept))
    assert _read("boundary_ms.gat") == _read("boundary_ms")
