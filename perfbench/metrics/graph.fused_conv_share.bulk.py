"""Share of the fused graph's convolutions whose epilogue (bias, residual,
ReLU) cuDNN ran in the convolution's own call: 100 x the ``fused_convs``
over the ``convs`` that the program puts on the window's ``serving.launch``
spans; nothing where the spans carry no counts (a program that does not
count them).  It should move ``frames_per_s``."""

from perfbench.program_spans import _window_records


def read(trace):
    counts = [r[6] for r in _window_records(trace) or [] if r[2] == "serving.launch"]
    convs = sum(c.get("convs", 0) for c in counts)
    return 100.0 * sum(c.get("fused_convs", 0) for c in counts) / convs if convs else None
