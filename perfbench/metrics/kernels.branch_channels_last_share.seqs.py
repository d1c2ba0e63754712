"""Share of the MTSR's pattern-branch convolutions (two in each of the
per-reading branches) that took their input channels-last (NHWC), as
cuDNN's bf16 kernels read it: 100 x ``sr_branch_conv_nhwc`` over
``sr_branch_conv``, the program's own counters as the window's
``trainer.replays`` spans carry them (their ``launches`` attr, replays of
the captured step included); nothing where the spans carry no such counts
(a program that does not count them).  It should move
``train_samples_per_s``."""

from perfbench.program_spans import _window_records


def read(trace):
    counts = [r[6]["launches"] for r in _window_records(trace) or []
              if r[2] == "trainer.replays" and "launches" in r[6]]
    total = sum(c.get("sr_branch_conv", 0) for c in counts)
    return 100.0 * sum(c.get("sr_branch_conv_nhwc", 0) for c in counts) / total if total else None
