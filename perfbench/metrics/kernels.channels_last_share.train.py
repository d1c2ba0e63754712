"""Share of the SR training step's convolutions and BatchNorms that took
their input channels-last (NHWC), as cuDNN's bf16 kernels read it, with no
transpose or f32 copy around them: 100 x (``sr_conv_nhwc`` +
``sr_bn_nhwc``) over (``sr_conv`` + ``sr_bn``), the program's own counters
as the window's ``trainer.replays`` spans carry them (their ``launches``
attr, replays of the captured step included); nothing where the spans
carry no such counts (a program that does not count them).  It should move
``train_samples_per_s``."""

from perfbench.program_spans import _window_records

NATIVE, ALL = ("sr_conv_nhwc", "sr_bn_nhwc"), ("sr_conv", "sr_bn")


def read(trace):
    counts = [r[6]["launches"] for r in _window_records(trace) or []
              if r[2] == "trainer.replays" and "launches" in r[6]]
    total = sum(c.get(k, 0) for c in counts for k in ALL)
    return 100.0 * sum(c.get(k, 0) for c in counts for k in NATIVE) / total if total else None
