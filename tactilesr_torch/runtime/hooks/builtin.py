"""Built-in hooks: LR updates, checkpointing, evaluation, console/TB logging
(the port's copy of ``tactilesr_tpu/runtime/hooks/builtin.py``).

Contract parity (reference cpu/hooks/*):
- LRUpdateHook (lr_update_hook.py:5-43): priority 2; drives the warmup
  schedule's epoch_update/iter_update; plateau mode pulls "Eval Metric" from
  the metric storage.
- CheckpointHook (checkpoint_hook.py:8-58): saves ``epoch_{e}`` /
  ``iter_{i}`` every period (and at train end), keeps newest max_to_keep,
  checkpointable.
- EvalHook (eval_hook.py:6-52): priority 1; runs eval_func every period
  epochs/iters and at train end; float-dict results logged unsmoothed.
- LoggerHook (logger_hook.py:14-106): priority 10 (last); console line every
  ``period`` inner iters with epoch/iter, ETA, smoothed losses, iter/data
  time, lr, device memory (one line per epoch under ``scan_epochs``);
  TensorBoard scalars with last-written-iter dedup; total-time summary at
  train end.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Callable, Dict, Optional

import torch

from ..logger import ScalarWriter
from .hookbase import HookBase

logger = logging.getLogger("tactilesr_torch")

__all__ = ["LRUpdateHook", "CheckpointHook", "EvalHook", "LoggerHook"]


class LRUpdateHook(HookBase):
    priority = 2

    def after_iter(self) -> None:
        self.trainer.lr_schedule.iter_update()

    def after_epoch(self) -> None:
        sched = self.trainer.lr_schedule
        if getattr(sched.inner, "is_plateau", False):
            storage = self.trainer.metric_storage
            assert "Eval Metric" in storage, (
                "plateau LR scheduling needs an EvalHook logging 'Eval Metric'"
            )
            self.trainer.flush_metrics()
            sched.epoch_update(storage["Eval Metric"].latest)
        else:
            sched.epoch_update()


class CheckpointHook(HookBase):
    priority = 3

    def __init__(self, period: int = 1, max_to_keep: Optional[int] = None):
        self._period = period
        self._max_to_keep = max_to_keep

    def before_train(self) -> None:
        self.trainer.ckpt_manager.max_to_keep = self._max_to_keep

    def after_epoch(self) -> None:
        if self.every_n_epochs(self._period) or self.is_last_epoch():
            self.trainer.save_checkpoint(f"epoch_{self.trainer.cur_epoch}.pth")

    def after_iter(self) -> None:
        if not self.trainer.train_by_epoch and (
            self.every_n_iters(self._period) or self.is_last_iter()
        ):
            self.trainer.save_checkpoint(f"iter_{self.trainer.cur_iter}.pth")

    def state_dict(self) -> dict:
        return self.trainer.ckpt_manager.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.trainer.ckpt_manager.load_state_dict(state)


class EvalHook(HookBase):
    priority = 1

    def __init__(self, period: int, eval_func: Callable[[], Optional[Dict[str, float]]]):
        self._period = period
        self._eval_func = eval_func

    def _do_eval(self) -> None:
        res = self._eval_func()
        if res is None:
            return
        assert isinstance(res, dict), "eval_func must return a dict or None"
        for k, v in res.items():
            assert isinstance(v, (int, float)), (
                f"eval result '{k}' must be a scalar, got {type(v)}"
            )
        self.trainer.flush_metrics()
        self.trainer.log(self.trainer.cur_iter, smooth=False, **res)

    def after_epoch(self) -> None:
        if self.every_n_epochs(self._period) and not self.is_last_epoch():
            self._do_eval()

    def after_iter(self) -> None:
        if not self.trainer.train_by_epoch and (
            self.every_n_iters(self._period) and not self.is_last_iter()
        ):
            self._do_eval()

    def after_train(self) -> None:
        self._do_eval()


class LoggerHook(HookBase):
    priority = 10  # last, so it sees everything the others logged

    def __init__(self, period: int = 50, tb_log_dir: str = "tb_logs"):
        self._period = period
        self._tb_log_dir = tb_log_dir
        self._writer: Optional[ScalarWriter] = None
        self._last_written: Dict[str, int] = {}

    def before_train(self) -> None:
        self._writer = ScalarWriter(self._tb_log_dir)
        self._train_start = time.perf_counter()
        self._hook_time = 0.0

    def after_train(self) -> None:
        total = time.perf_counter() - self._train_start
        logger.info(
            "Total training time: %s",
            str(datetime.timedelta(seconds=int(total))),
        )
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()

    def _eta(self) -> str:
        t = self.trainer
        elapsed = time.perf_counter() - self._train_start
        done = t.cur_iter - t.start_iter + 1
        remaining = (t.max_iters - t.cur_iter - 1) * elapsed / max(done, 1)
        return str(datetime.timedelta(seconds=int(remaining)))

    def _write_console(self) -> None:
        t = self.trainer
        storage = t.metric_storage
        pieces = []
        if t.train_by_epoch:
            pieces.append(f"epoch: {t.cur_epoch}|{t.max_epochs}")
            pieces.append(f"inner_iter: {t.inner_iter}|{t.epoch_len}")
        pieces.append(f"iter: {t.cur_iter}|{t.max_iters}")
        pieces.append(f"ETA: {self._eta()}")
        for key in storage.keys():
            if key in ("lr", "data_time", "iter_time"):
                continue
            if "loss" in key.lower() or key in ("total_loss",):
                pieces.append(f"{key}: {storage[key].avg:.4g}")
        for key in ("iter_time", "data_time"):
            if key in storage:
                pieces.append(f"{key}: {storage[key].avg:.4f}s")
        if "lr" in storage:
            pieces.append(f"lr: {storage['lr'].latest:.3g}")
        mem = self._max_device_memory()
        if mem > 0:
            pieces.append(f"max_mem: {mem / 2**30:.1f}G")
        logger.info("  ".join(pieces))

    def _max_device_memory(self) -> int:
        """Peak bytes allocated on the trainer's CUDA device (the reference
        logs CUDA max_memory_allocated every period,
        cpu/hooks/logger_hook.py:59-68); 0 on the CPU."""
        dev = self.trainer.device
        return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    def _write_tensorboard(self) -> None:
        storage = self.trainer.metric_storage
        for key, (it, value) in storage.values_maybe_smooth.items():
            if self._last_written.get(key, -1) < it:
                self._writer.add_scalar(key, value, it)
                self._last_written[key] = it

    def after_iter(self) -> None:
        if self.every_n_inner_iters(self._period) if self.trainer.train_by_epoch else self.every_n_iters(self._period):
            self.trainer.flush_metrics()
            self._write_console()
            self._write_tensorboard()

    def after_epoch(self) -> None:
        self.trainer.flush_metrics()
        if self.trainer.scan_epochs:
            # no per-iteration callbacks in the scan path: one console line
            # per epoch instead
            self._write_console()
        self._write_tensorboard()
