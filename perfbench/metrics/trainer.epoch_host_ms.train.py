"""Device-idle time at a captured epoch's boundary, per epoch: the
program's ``trainer.prepare`` (the order, the learning rates, the buffer
copies), ``trainer.fetch`` (the losses) and ``trainer.log`` spans, minus
the device's busy time inside them, over the traced ``trainer.epoch``
spans.  It should move ``train_samples_per_s``."""

from perfbench.program_spans import idle_ms_per


def read(trace):
    return idle_ms_per(trace, ("trainer.prepare", "trainer.fetch", "trainer.log"), "trainer.epoch")
