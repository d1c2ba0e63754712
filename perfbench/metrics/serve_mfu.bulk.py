"""The served model's share of the card's bf16 peak: the frozen conv FLOPs
a frame times the frames served per second over the whole window, over
989 TFLOP/s.  It bounds the kernels' roofline share from the whole call's
side; it should move ``frames_per_s``."""

from perfbench.workcount import PEAK_BF16_FLOPS


def read(trace):
    c = trace.counters if trace is not None else {}
    if not c.get("frames_per_s"):
        return None
    return 100.0 * c["flops_per_frame"] * c["frames_per_s"] / PEAK_BF16_FLOPS
