"""Optimizer kernel launches a training step in ``tpsf-stage1-train``, from the
program's own counter: what ``adam_l2`` (AdamL2 over every parameter
tensor in one launch) gained over the traced epochs' ``trainer.replays``
spans (their ``launches`` attr, replays of the captured step included),
over those epochs' steps.  1.0 when every step runs the optimizer as one
launch, 0 on a path without the kernel (the CPU's); nothing where the
program has no such counter.  It should move ``train_samples_per_s``."""

from perfbench.optim_trace import adam_launches_per_step


def read(trace):
    return adam_launches_per_step(trace)
