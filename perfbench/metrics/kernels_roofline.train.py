"""The kernels' share of their roofline while training: the frozen work of
the profiled steps (three forwards' conv FLOPs a sample) over the bf16
peak, over the device's busy time.  It should move
``train_samples_per_s``."""

from perfbench.workcount import least_seconds


def read(trace):
    busy = trace.busy_s() if trace is not None else 0
    c = trace.counters if trace is not None else {}
    if busy <= 0 or not c.get("samples"):
        return None
    least, _ = least_seconds(c["flops_per_sample"] * c["samples"], 0)
    return 100.0 * least / busy
