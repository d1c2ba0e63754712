"""The program's own spans in a traced window: the records of
``tactilesr_torch.runtime.tracing``, which the program keeps in memory
while a torch profiler runs, on the clock of the device events.  A reader
runs after the driver in the same process, so the window's records are
still there.
"""

from __future__ import annotations


def _window_records(trace):
    """The program's records that overlap the traced window; ``None`` where
    the program has no tracer (an older version) or dropped records."""
    try:
        from tactilesr_torch.runtime import tracing
    except ImportError:
        return None
    if trace is None or tracing.dropped():
        return None
    return [r for r in tracing.records() if r[1] > trace.start_ns and r[0] < trace.end_ns]


def idle_ms_per(trace, names, root: str, attr: str | None = None) -> float | None:
    """Device-idle ms inside the spans named in ``names`` (each span, clipped
    to the window, minus the device's busy time inside it), over the
    ``root`` spans' sum of ``attr`` (their count where ``attr`` is None);
    ``None`` where there is nothing to read."""
    records = _window_records(trace) or []
    spans = [(max(r[0], trace.start_ns), min(r[1], trace.end_ns)) for r in records if r[2] in names]
    roots = [r for r in records if r[2] == root]
    per = sum(r[6].get(attr, 0) for r in roots) if attr else len(roots)
    if not spans or not per:
        return None
    return 1e3 * sum((e - s) / 1e9 - trace.busy_s(s, e) for s, e in spans) / per
