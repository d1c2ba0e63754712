"""The kernels' share of their roofline while serving: the least time the
frozen work of the profiled frames could take on the card (the original
graph's conv FLOPs over the bf16 peak, or each frame's reading in and map
out over HBM bandwidth, whichever is longer), over the device's busy time.
It should move ``frames_per_s``."""

from perfbench.workcount import least_seconds


def read(trace):
    busy = trace.busy_s() if trace is not None else 0
    c = trace.counters if trace is not None else {}
    if busy <= 0 or not c.get("frames"):
        return None
    least, _ = least_seconds(c["flops_per_frame"] * c["frames"], c["bytes_per_frame"] * c["frames"])
    return 100.0 * least / busy
