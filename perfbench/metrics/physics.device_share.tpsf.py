"""The physics kernels' share of the device's busy time while training
tPSFNet: the profiled launches of ``tpsf_physics_kernel`` and
``tpsf_physics_bwd_kernel``, over the union of every kernel, copy and
memset.  It should move ``train_samples_per_s``."""

from perfbench.physics_count import BACKWARD_KERNEL, FORWARD_KERNEL
from perfbench.physics_trace import kernel_events


def read(trace):
    busy = trace.busy_s() if trace is not None else 0
    if busy <= 0:
        return None
    return 100.0 * sum(sum(kernel_events(trace, k)) for k in (FORWARD_KERNEL, BACKWARD_KERNEL)) / 1e9 / busy
