"""Device-idle time at a captured tPSFNet epoch's boundary, per epoch, read
as ``trainer.epoch_host_ms.train`` reads it (the program's
``trainer.prepare``, ``trainer.fetch`` and ``trainer.log`` spans).  It
should move ``train_samples_per_s``."""

from perfbench.core import load_module


def read(trace):
    return load_module("metrics", "trainer.epoch_host_ms.train").read(trace)
