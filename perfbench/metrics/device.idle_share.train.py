"""Share of the profiled window in which no kernel, copy or memset ran on
the card; it should move ``train_samples_per_s``."""


def read(trace):
    if trace is None:
        return None
    w = trace.window_s()
    return 100.0 * (1 - trace.busy_s() / w) if w > 0 and trace.busy_s() > 0 else None
