"""Share of ``SRPredictor.predict``'s chunks whose fetch began after the
next chunk was enqueued, so that the device ran that chunk while the host
waited for and copied out this one: 100 x the ``overlapped`` over the
``chunks`` that the program puts on the window's ``serving.predict`` spans;
nothing where the spans carry no ``overlapped`` (a program that does not
pipeline its chunks).  It should move ``frames_per_s``."""

from perfbench.program_spans import _window_records


def read(trace):
    roots = [r[6] for r in _window_records(trace) or [] if r[2] == "serving.predict"]
    chunks = sum(a.get("chunks", 0) for a in roots)
    if not chunks or not any("overlapped" in a for a in roots):
        return None
    return 100.0 * sum(a.get("overlapped", 0) for a in roots) / chunks
