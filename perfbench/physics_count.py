"""The tPSF physics kernels' work counts, frozen, and tPSFNet's step.

Copies of ``tactilesr_torch/bench.py``'s counts (``tpsf_bound_ms``,
``tpsf_bwd_bound_ms``; tested equal there): per sample, the f32 forward
``tpsf_physics_kernel`` does the banded products ``A D A^T`` (7,450 taps of
``A`` a row pass, 2 FLOPs a tap, two passes over 100 columns) and the
degradation ``U HR U^T``; the backward ``tpsf_physics_bwd_kernel``, as
training calls it (LR cotangent in, abm gradient out), recomputes the two
banded products and does three more (``Q = G0 A`` and the two
correlations with the band of dL/dA), and the degradation's backward at
twice its forward.  Bytes: each input read once and each output written
once.  Elementwise work is left out.  They stay as they are when a kernel
changes, so the physics roofline counts the same work whatever computes it.
"""

from __future__ import annotations

from .workcount import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, TRAIN_FORWARDS, least_seconds

BAND = sum(min(99, i + 49) - max(0, i - 49) + 1 for i in range(100))  # 7,450 taps of A(beta)
DEGRADE = 2 * (4 * 100 * 100 + 4 * 4 * 100)  # U HR U^T
FORWARD_FLOPS = 2 * 2 * BAND * 100 + DEGRADE  # 3,063,200 a sample
BACKWARD_FLOPS = 5 * 2 * BAND * 100 + 2 * DEGRADE  # 7,616,400
FORWARD_BYTES = 4 * (100 * 100 + 3 + 100 * 100 + 16)  # depth, abm in; HR, LR out
BACKWARD_BYTES = 4 * (100 * 100 + 3 + 16 + 3)  # depth, abm, the LR cotangent in; the abm gradient out
MLP_FLOPS = 2 * (48 * 256 + 256 * 1024 + 1024 * 256 + 256 * 3)  # one forward, 1,074,688

# kernel names as the device trace gives them (the C++ names, demangled)
FORWARD_KERNEL = "tpsf_physics_kernel"
BACKWARD_KERNEL = "tpsf_physics_bwd_kernel"


def kernel_least_seconds(kernel: str, batch: int) -> float:
    """The least time of one launch of ``kernel`` over ``batch`` samples at
    the f32 peak or HBM bandwidth, whichever is longer."""
    flops, nbytes = {FORWARD_KERNEL: (FORWARD_FLOPS, FORWARD_BYTES),
                     BACKWARD_KERNEL: (BACKWARD_FLOPS, BACKWARD_BYTES)}[kernel]
    return least_seconds(batch * flops, batch * nbytes, PEAK_F32_FLOPS)[0]


def step_least_seconds_per_sample() -> float:
    """A training sample's least time: the physics forward and backward at
    the f32 peak, the MLP's step (three forwards) at the bf16 peak."""
    return (FORWARD_FLOPS + BACKWARD_FLOPS) / PEAK_F32_FLOPS + TRAIN_FORWARDS * MLP_FLOPS / PEAK_BF16_FLOPS
