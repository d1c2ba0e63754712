"""Device-idle time between a captured epoch's steps, per epoch: the
program's ``trainer.replays`` spans (the eager steps, the capture and the
replays), minus the device's busy time inside them, over the traced
``trainer.epoch`` spans.  It should move ``train_samples_per_s``."""

from perfbench.program_spans import idle_ms_per


def read(trace):
    return idle_ms_per(trace, ("trainer.replays",), "trainer.epoch")
