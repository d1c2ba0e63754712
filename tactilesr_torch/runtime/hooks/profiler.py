"""Profiler hook: a ``torch.profiler`` trace over a window of training
iterations (the port of ``tactilesr_tpu/runtime/hooks/profiler.py``).

The window is [start_iter, start_iter + num_iters), as in the JAX hook.  It
records CPU activity, and CUDA activity when the trainer runs on a GPU, and
writes a Chrome trace (viewable in Perfetto or chrome://tracing) into
``trace_dir`` when the window closes, or at train end if training stops
inside it.  Under ``scan_epochs``, where only the epoch hooks fire, the
window opens before the epoch that holds ``start_iter`` and closes after
the epoch that holds its last iteration.  The trace holds the trainer's
spans (``runtime/tracing.py``), which record while the profiler runs.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from .hookbase import HookBase

logger = logging.getLogger("tactilesr_torch")

__all__ = ["ProfilerHook"]


class ProfilerHook(HookBase):
    """Trace iterations [start_iter, start_iter + num_iters)."""

    priority = 4

    def __init__(self, trace_dir: str, start_iter: int = 10, num_iters: int = 5):
        self._trace_dir = trace_dir
        self._start = start_iter
        self._stop = start_iter + num_iters
        self._prof = None
        self.trace_path: Optional[str] = None  # the Chrome trace, once written

    def before_iter(self) -> None:
        if self.trainer.cur_iter == self._start:
            self._begin()

    def after_iter(self) -> None:
        self._end()

    def before_epoch(self) -> None:
        t = self.trainer
        if t.scan_epochs and t.cur_iter <= self._start < t.cur_iter + t.epoch_len:
            self._begin()

    def after_epoch(self) -> None:
        if self.trainer.scan_epochs:
            self._end()

    def _begin(self) -> None:
        if self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.trainer.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self._trace_dir, exist_ok=True)
        self._prof = profile(activities=activities)
        self._prof.start()
        logger.info("profiler trace started -> %s", self._trace_dir)

    def _end(self) -> None:
        """Close the window after its last iteration (``cur_iter``)."""
        if self._prof is not None and self.trainer.cur_iter + 1 >= self._stop:
            self.trainer.flush_metrics()  # the window's device work into the trace
            self._finish()
            logger.info("profiler trace stopped (%d iters) -> %s", self._stop - self._start,
                        self.trace_path)

    def after_train(self) -> None:
        if self._prof is not None:
            self._finish()

    def _finish(self) -> None:
        prof, self._prof = self._prof, None
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)
        prof.stop()
        self.trace_path = os.path.join(self._trace_dir, f"trace_iter_{self._start}_{self._stop}.json")
        prof.export_chrome_trace(self.trace_path)
