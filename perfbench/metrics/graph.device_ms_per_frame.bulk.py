"""Device busy time of the fused serving graph per served frame (the
profiled requests' kernels and copies, their union, over the frames they
served); it should move ``frames_per_s``."""


def read(trace):
    busy = trace.busy_s() if trace is not None else 0
    return 1e3 * busy / trace.counters["frames"] if busy > 0 and trace.counters.get("frames") else None
