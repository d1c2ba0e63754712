"""What the tPSFNet cell's readers take from a traced window: the physics
kernels' device events, and the launch counts that the program puts on
its ``trainer.replays`` spans (``tactilesr_torch.runtime.trainer``)."""

from __future__ import annotations

import re

from .program_spans import _window_records


def kernel_events(trace, kernel: str) -> list:
    """Durations (ns, clipped to the window) of the device events of the C++
    kernel ``kernel`` (its demangled name, with or without arguments)."""
    name = re.compile(rf"(^|[^\w]){re.escape(kernel)}([^\w]|$)")
    return [min(e, trace.end_ns) - max(s, trace.start_ns) for s, e, n in trace.device
            if e > trace.start_ns and s < trace.end_ns and name.search(n)]


def launches_per_step(trace, counters) -> float | None:
    """The launches the named counters gained over the window's
    ``trainer.replays`` spans, over the steps of their ``trainer.epoch``
    roots; ``None`` where the program records no launch counts."""
    records = _window_records(trace) or []
    replays = [r for r in records if r[2] == "trainer.replays" and "launches" in r[6]]
    steps = {r[3]: r[6].get("steps", 0) for r in records if r[2] == "trainer.epoch"}
    total = sum(steps.get(r[5], 0) for r in replays)
    if not total:
        return None
    return sum(r[6]["launches"].get(c, 0) for r in replays for c in counters) / total
