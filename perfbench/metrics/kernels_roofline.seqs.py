"""The kernels' share of their roofline while training the MTSR, read as
``kernels_roofline.train`` reads it: the frozen conv FLOPs of the profiled
samples (three forwards a sample, at the configuration's widths) over the
bf16 peak, over the device's busy time.  It should move
``train_samples_per_s``."""

from perfbench.core import load_module


def read(trace):
    return load_module("metrics", "kernels_roofline.train").read(trace)
