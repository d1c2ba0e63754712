"""Profiler hook: a ``torch.profiler`` trace over a window of training
iterations (the port of ``tactilesr_tpu/runtime/hooks/profiler.py``).

The window is [start_iter, start_iter + num_iters), as in the JAX hook.  It
records CPU activity, and CUDA activity when the trainer runs on a GPU, and
writes a Chrome trace (viewable in Perfetto or chrome://tracing) into
``trace_dir`` when the window closes, or at train end if training stops
inside it.  Like every per-iteration hook it does not fire under
``scan_epochs``.
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
        if self.trainer.cur_iter == self._start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.trainer.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self._trace_dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.start()
            logger.info("profiler trace started -> %s", self._trace_dir)

    def after_iter(self) -> None:
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
