"""The MTSR training step's share of the card's bf16 peak, read as
``train_mfu.train`` reads it: three forwards' conv FLOPs a sample times the
samples trained per second over the whole window, over 989 TFLOP/s.  It
should move ``train_samples_per_s``."""

from perfbench.core import load_module


def read(trace):
    return load_module("metrics", "train_mfu.train").read(trace)
