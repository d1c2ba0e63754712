"""Device-idle time between a captured tPSFNet epoch's steps, per epoch,
read as ``trainer.replay_idle_ms.train`` reads it (the program's
``trainer.replays`` spans).  It should move ``train_samples_per_s``."""

from perfbench.core import load_module


def read(trace):
    return load_module("metrics", "trainer.replay_idle_ms.train").read(trace)
