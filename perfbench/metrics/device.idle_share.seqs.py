"""Share of the profiled MTSR training window in which no kernel, copy or
memset ran on the card, read as ``device.idle_share.train`` reads it.  It
should move ``train_samples_per_s``."""

from perfbench.core import load_module


def read(trace):
    return load_module("metrics", "device.idle_share.train").read(trace)
