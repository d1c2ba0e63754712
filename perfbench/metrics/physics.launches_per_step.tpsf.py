"""Physics kernel launches a training step, from the program's own
counters: what ``tpsf_physics`` (the f32 forward kernel) and
``tpsf_physics_bwd`` (the backward kernel) gained over the traced epochs'
``trainer.replays`` spans (their ``launches`` attr, replays of the
captured step included), over those epochs' steps.  2.0 when every step
runs the physics through its two kernels, 0 on the plain path.  It should
move ``train_samples_per_s``."""

from perfbench.physics_trace import launches_per_step


def read(trace):
    return launches_per_step(trace, ("tpsf_physics", "tpsf_physics_bwd"))
