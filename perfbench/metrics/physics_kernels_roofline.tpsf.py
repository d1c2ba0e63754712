"""The physics kernels' share of their roofline while training tPSFNet: the
least time of every profiled launch of ``tpsf_physics_kernel`` and
``tpsf_physics_bwd_kernel`` at the cell's batch (the frozen counts of
``perfbench/physics_count.py``, f32 peak or HBM bandwidth), over those
kernels' device time.  It should move ``train_samples_per_s``."""

from perfbench.physics_count import BACKWARD_KERNEL, FORWARD_KERNEL, kernel_least_seconds
from perfbench.physics_trace import kernel_events


def read(trace):
    if trace is None or not trace.counters.get("batch"):
        return None
    least = busy = 0.0
    for kernel in (FORWARD_KERNEL, BACKWARD_KERNEL):
        times = kernel_events(trace, kernel)
        least += len(times) * kernel_least_seconds(kernel, trace.counters["batch"])
        busy += sum(times) / 1e9
    return 100.0 * least / busy if busy > 0 else None
