"""The tPSFNet training step's share of the card's peaks: the frozen least
time of a sample (the physics forward and backward at the f32 peak, the
MLP's three forwards at the bf16 peak; ``perfbench/physics_count.py``)
times the samples trained per second over the whole window.  It should
move ``train_samples_per_s``."""


def read(trace):
    c = trace.counters if trace is not None else {}
    if not c.get("samples_per_s") or not c.get("least_s_per_sample"):
        return None
    return 100.0 * c["least_s_per_sample"] * c["samples_per_s"]
