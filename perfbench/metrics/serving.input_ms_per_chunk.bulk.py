"""Device-idle time of ``SRPredictor.predict``'s input phase per chunk: the
program's ``serving.prepare`` (bucket, pad, split) and ``serving.h2d``
(the host-to-device copies) spans, minus the device's busy time inside
them, over the traced requests' chunks (``serving.predict``'s ``chunks``).
It should move ``frames_per_s``."""

from perfbench.program_spans import idle_ms_per


def read(trace):
    return idle_ms_per(trace, ("serving.prepare", "serving.h2d"), "serving.predict", "chunks")
