"""Device operations (kernels, copies, memsets) per training step in the
profiled epochs.  Each is a launch and a pass over memory; fewer should
move ``train_samples_per_s``."""


def read(trace):
    if trace is None or not trace.counters.get("steps"):
        return None
    n = sum(1 for s, e, _ in trace.device if e > trace.start_ns and s < trace.end_ns)
    return n / trace.counters["steps"] if n else None
