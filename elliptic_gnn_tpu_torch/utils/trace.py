"""The port's spans and counters: one recorder a process, always on.

    from elliptic_gnn_tpu_torch.utils import trace

    with trace.span("setup.build", arch="gat") as sp:
        ...
        sp.attrs["rows"] = 3
    trace.count("kernel_builds", 5)
    trace.last("setup.build").seconds

A span records its name, an id, the id of the span open around it (its
parent), its start and end, and its attrs; it also keeps
the summed duration of its children by name, so that its self time is its
duration less theirs. Every span is a torch.profiler.record_function range
too where a profiler is on: it then sits in the Chrome trace as a
`user_annotation` event. Starts and ends are stamped on time.time_ns, the
clock of that trace (an event's `ts` plus the trace's
`baseTimeNanoseconds`); durations come from the monotonic
time.perf_counter_ns. A span's stamps lie inside its profiler range.

Memory is bounded: the last MAX_SPANS spans, the last span of each name,
and a count and a total a name. The trainer opens spans at set-up stages
and K-loop block boundaries only, never inside a captured epoch, so they
cost microseconds a block. Spans are opened from one thread: a sweep's
parallel runs are processes, each with its own recorder.

Readers (the benchmark's per-layer metrics, tests) read the process's
recorder through the module functions below, which go to `RECORDER` when
called.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch.autograd.profiler import record_function

MAX_SPANS = 8192
# whether a profiler is on: a span enters its record_function range only
# then (a range opened with none on is not recorded, and costs ~10 us)
_profiler_on = getattr(torch._C._autograd, "_profiler_enabled", lambda: True)


class Span:
    """One timed stretch. `end_ns` is None while the span is open."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "attrs", "children_ns")

    def __init__(self, name: str, span_id: int, parent: Optional[int], attrs: dict):
        self.name, self.id, self.parent, self.attrs = name, span_id, parent, attrs
        self.start_ns: int = 0
        self.end_ns: Optional[int] = None
        self.children_ns: Dict[str, int] = {}

    @property
    def seconds(self) -> float:
        return 0.0 if self.end_ns is None else (self.end_ns - self.start_ns) * 1e-9

    def child_seconds(self, name: str) -> Optional[float]:
        """Summed duration of the children named `name`; None where none ran."""
        ns = self.children_ns.get(name)
        return None if ns is None else ns * 1e-9

    def to_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "attrs": self.attrs,
                "children_s": {k: v * 1e-9 for k, v in self.children_ns.items()}}


class Recorder:
    """Spans and counters of one process. `clock` returns (wall ns,
    monotonic ns); tests give it a clock of their own."""

    def __init__(self, max_spans: int = MAX_SPANS,
                 clock: Optional[Callable[[], tuple]] = None):
        self.max_spans = int(max_spans)
        self._clock = clock or (lambda: (time.time_ns(), time.perf_counter_ns()))
        self.reset()

    def reset(self) -> None:
        self._spans: collections.deque = collections.deque(maxlen=self.max_spans)
        self._last: Dict[str, Span] = {}
        self._totals: Dict[str, List[int]] = {}  # name -> [count, total ns]
        self._counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._stack: List[Span] = []  # the open spans, innermost last

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        """Time the body as span `name`; yields the Span, whose attrs the
        body may add to."""
        stack = self._stack
        parent = stack[-1] if stack else None
        sp = Span(name, next(self._ids), None if parent is None else parent.id, attrs)
        with record_function(name) if _profiler_on() else contextlib.nullcontext():
            wall0, mono0 = self._clock()
            sp.start_ns = wall0
            stack.append(sp)
            try:
                yield sp
            finally:
                stack.pop()
                dur = self._clock()[1] - mono0
                sp.end_ns = wall0 + dur
                self._spans.append(sp)
                self._last[name] = sp
                tot = self._totals.setdefault(name, [0, 0])
                tot[0] += 1
                tot[1] += dur
                if parent is not None:
                    parent.children_ns[name] = parent.children_ns.get(name, 0) + dur

    def count(self, name: str, n: int = 1) -> int:
        """Add `n` to counter `name`; returns its new value."""
        value = self._counters[name] = self._counters.get(name, 0) + int(n)
        return value

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """The kept spans (the last `max_spans`) in the order they ended,
        those named `name` where given."""
        kept = list(self._spans)
        return kept if name is None else [s for s in kept if s.name == name]

    def last(self, name: str) -> Optional[Span]:
        """The last span named `name` to end, kept whatever the bound."""
        return self._last.get(name)

    def counters(self) -> Dict[str, int]:
        return dict(self._counters)

    def totals(self) -> Dict[str, dict]:
        """Per name, every span that ended: {"count", "seconds"}."""
        return {k: {"count": c, "seconds": ns * 1e-9} for k, (c, ns) in self._totals.items()}

    def write(self, path: str) -> None:
        """The kept spans, the totals and the counters as JSON at `path`."""
        out = {"max_spans": self.max_spans, "spans": [s.to_dict() for s in self.spans()],
               "totals": self.totals(), "counters": self.counters()}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(out, fh)


RECORDER = Recorder()


def span(name: str, **attrs):
    return RECORDER.span(name, **attrs)


def count(name: str, n: int = 1) -> int:
    return RECORDER.count(name, n)


def spans(name: Optional[str] = None) -> List[Span]:
    return RECORDER.spans(name)


def last(name: str) -> Optional[Span]:
    return RECORDER.last(name)


def counters() -> Dict[str, int]:
    return RECORDER.counters()


def totals() -> Dict[str, dict]:
    return RECORDER.totals()


def reset() -> None:
    RECORDER.reset()


def write(path: str) -> None:
    RECORDER.write(path)
