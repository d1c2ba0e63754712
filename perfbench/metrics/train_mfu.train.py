"""The training step's share of the card's bf16 peak: three forwards' conv
FLOPs a sample times the samples trained per second over the whole window,
over 989 TFLOP/s.  It should move ``train_samples_per_s``."""

from perfbench.workcount import PEAK_BF16_FLOPS


def read(trace):
    c = trace.counters if trace is not None else {}
    if not c.get("samples_per_s"):
        return None
    return 100.0 * c["flops_per_sample"] * c["samples_per_s"] / PEAK_BF16_FLOPS
