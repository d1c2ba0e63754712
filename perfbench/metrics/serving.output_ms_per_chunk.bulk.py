"""Device-idle time of ``SRPredictor.predict``'s output phase per chunk:
the program's ``serving.fetch`` (the wait, the device-to-host copy, the
concatenation and slice) and ``serving.assemble`` (the request's
concatenation) spans, minus the device's busy time inside them, over the
traced requests' chunks (``serving.predict``'s ``chunks``).  It should
move ``frames_per_s``."""

from perfbench.program_spans import idle_ms_per


def read(trace):
    return idle_ms_per(trace, ("serving.fetch", "serving.assemble"), "serving.predict", "chunks")
