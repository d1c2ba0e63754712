"""Device operations (kernels, copies, memsets) per MTSR training step in
the profiled epochs, read as ``trainer.device_ops_per_step.train`` reads
them.  It should move ``train_samples_per_s``."""

from perfbench.core import load_module


def read(trace):
    return load_module("metrics", "trainer.device_ops_per_step.train").read(trace)
