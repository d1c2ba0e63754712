"""What the training cells' optimizer readers take from a traced window:
the optimizer kernel's launches a step, from the ``adam_l2`` counter that
the program puts on its ``trainer.replays`` spans
(``tactilesr_torch.ops.cuda.launch_counts``, replays of the captured step
included)."""

from __future__ import annotations

from .physics_trace import launches_per_step
from .program_spans import _window_records


def adam_launches_per_step(trace) -> float | None:
    """``adam_l2`` launches over the window's steps; ``None`` where the
    spans carry no such counter (a program without the optimizer kernel)
    or the window holds no step."""
    counted = any("adam_l2" in r[6]["launches"] for r in _window_records(trace) or []
                  if r[2] == "trainer.replays" and "launches" in r[6])
    return launches_per_step(trace, ("adam_l2",)) if counted else None
