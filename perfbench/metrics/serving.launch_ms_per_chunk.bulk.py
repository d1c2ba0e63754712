"""Device-idle time while ``SRPredictor.predict`` enqueues the fused
graph's kernels, per chunk: the program's ``serving.launch`` spans, minus
the device's busy time inside them, over the traced requests' chunks
(``serving.predict``'s ``chunks``).  It should move ``frames_per_s``."""

from perfbench.program_spans import idle_ms_per


def read(trace):
    return idle_ms_per(trace, ("serving.launch",), "serving.predict", "chunks")
