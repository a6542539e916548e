"""Reading torch.profiler's Chrome trace of a traced stretch of the window:
the device's operations (kernels, copies, fills) and what the host was
doing in the gaps between them."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")


class Trace:
    """Times in seconds. `window_s` runs from the first device operation of
    the stretch to the end of the last; `busy_s` is the union of device
    activity in it."""

    def __init__(self, path: str):
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        self.device, self.host = [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            item = (str(ev.get("name", "")), float(ev["ts"]) * 1e-6, float(ev["dur"]) * 1e-6)
            if ev.get("cat") in DEVICE_CATS:
                self.device.append(item)
            elif ev.get("cat") in HOST_CATS:
                self.host.append(item)
        self.device.sort(key=lambda e: e[1])
        self.busy = self._union()

    def _union(self) -> list:
        spans = []
        for _, ts, dur in self.device:
            end = ts + dur
            if spans and ts <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], end)
            else:
                spans.append([ts, end])
        return spans

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    @property
    def window_s(self) -> float:
        return self.busy[-1][1] - self.busy[0][0] if self.busy else 0.0

    @property
    def total_s(self) -> float:
        """The device operations' own time, summed (overlaps counted twice)."""
        return sum(dur for _, _, dur in self.device)

    def seconds(self, patterns) -> float:
        """Summed time of the device operations whose name holds one of
        `patterns`."""
        return sum(dur for name, _, dur in self.device if any(p in name for p in patterns))

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for name, _, dur in self.device:
            by[name[:200]] += dur
        return sorted(([n, s] for n, s in by.items()), key=lambda e: -e[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The gaps between device activity, summed by the host operation
        that overlapped each gap the most ("host: no traced op" where none
        did)."""
        by = defaultdict(float)
        host = sorted(self.host, key=lambda e: e[1])
        starts = [ts for _, ts, _ in host]
        longest = max((dur for _, _, dur in host), default=0.0)
        for (_, a1), (b0, _) in zip(self.busy, self.busy[1:]):
            best, label = 0.0, "host: no traced op"
            j = bisect.bisect_left(starts, b0) - 1
            while j >= 0 and starts[j] > a1 - longest:
                name, ts, dur = host[j]
                ov = min(ts + dur, b0) - max(ts, a1)
                if ov > best:
                    best, label = ov, name[:200]
                j -= 1
            by[label] += b0 - a1
        return sorted(([n, s] for n, s in by.items()), key=lambda e: -e[1])[:k]
