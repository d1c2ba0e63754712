"""Host time of ``SRPredictor.predict`` per chunk of the predictor's
largest bucket: each traced request's span (the harness's own, around the
call), minus the device's busy time inside it, over its chunks.  The host
work is the split, pad and concatenate and each chunk's copies and wait;
it should move ``frames_per_s``."""

import math


def read(trace):
    spans = trace.span_items("predict") if trace is not None else []
    if not spans or "chunk_rows" not in trace.counters:
        return None
    c = trace.counters
    chunks = sum(math.ceil(sp[3]["rows"] / c["chunk_rows"]) for sp in spans)
    host = sum((sp[1] - sp[0]) / 1e9 - trace.busy_s(sp[0], sp[1]) for sp in spans)
    return 1e3 * host / chunks
