"""Share of the device's busy time in the profiled MTSR training window
spent in cuDNN's layout transposes (kernels named ``nchwToNhwcKernel`` or
``nhwcToNchwKernel``), which convert a convolution's NCHW operand to NHWC
and back: their intervals' union, clipped to the window, over the union of
every kernel, copy and memset.  0 where the window ran device work and no
transpose; nothing where it ran no device work.  It should move
``train_samples_per_s``."""

from perfbench.devtrace import _union

TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")


def read(trace):
    busy = trace.busy_s() if trace is not None else 0
    if busy <= 0:
        return None
    lo, hi = trace.start_ns, trace.end_ns
    spans = _union((max(s, lo), min(e, hi)) for s, e, name in trace.device
                   if e > lo and s < hi and any(t in name for t in TRANSPOSES))
    return 100.0 * sum(e - s for s, e in spans) / 1e9 / busy
