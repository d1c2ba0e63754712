"""What a traced run reads: the device's operations from torch.profiler,
the harness's own host spans, and counters.

Spans are recorded by the harness around its calls into the program
(``Spans.span``), on any thread, with ``time.time_ns()``: the profiler's
device events are in the same clock (nanoseconds since the epoch), so
spans and device intervals line up.  The profiler is started on the
thread that launches the device work.  Device time is the union of the kernel, copy and
memset intervals (GPU-side user annotations span kernels and are left
out), clipped to the traced window.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


class Spans:
    """Thread-safe (start_ns, end_ns, name, attrs) records."""

    def __init__(self):
        self.items: list = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = time.time_ns()
        try:
            yield attrs
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.items.append((t0, t1, name, attrs))


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclass
class Trace:
    """A traced window: ``device`` (start_ns, end_ns, name) operations,
    ``spans`` of the harness, ``counters`` set by the driver, and the
    window's bounds in ns."""

    start_ns: int
    end_ns: int
    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self, lo=None, hi=None) -> list:
        lo = self.start_ns if lo is None else lo
        hi = self.end_ns if hi is None else hi
        return _union((max(s, lo), min(e, hi)) for s, e, _ in self.device if e > lo and s < hi)

    def busy_s(self, lo=None, hi=None) -> float:
        return sum(e - s for s, e in self.busy_intervals(lo, hi)) / 1e9

    def span_items(self, name: str) -> list:
        return [sp for sp in self.spans if sp[2] == name and sp[1] > self.start_ns and sp[0] < self.end_ns]

    def idle_gaps(self) -> list:
        """(start_ns, end_ns) of the window's stretches with no device op."""
        gaps, t = [], self.start_ns
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end_ns > t:
            gaps.append((t, self.end_ns))
        return gaps

    def host_at(self, t_ns: int) -> str:
        """The innermost harness span open at ``t_ns`` (the latest begun)."""
        open_ = [sp for sp in self.spans if sp[0] <= t_ns < sp[1]]
        return max(open_, key=lambda sp: sp[0])[2] if open_ else "no span"

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(int)
        lo, hi = self.start_ns, self.end_ns
        for s, e, name in self.device:
            if e > lo and s < hi:
                ops[name] += min(e, hi) - max(s, lo)
        idle = defaultdict(int)
        for s, e in self.idle_gaps():
            idle[self.host_at(s)] += e - s
        return {"device_ops": [[n[:120], v / 1e9] for n, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[n, v / 1e9] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


def _device_events(prof) -> list:
    """(start_ns, end_ns, name) of every device op in a finished profile."""
    from torch.autograd import DeviceType

    return [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation()]


@contextlib.contextmanager
def traced(spans: Spans, cuda: bool = True):
    """Profile the block; yields a ``Trace`` that is filled on exit (its
    window is the block's host time, after a device synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tr = Trace(0, 0)
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        tr.start_ns = time.time_ns()
        yield tr
        if cuda:
            torch.cuda.synchronize()
        tr.end_ns = time.time_ns()
    tr.device = _device_events(prof) if cuda else []
    tr.spans = list(spans.items)
