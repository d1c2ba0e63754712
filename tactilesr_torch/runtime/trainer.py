"""Epoch/iteration trainer with a host-side hook bus (the port of
``tactilesr_tpu/runtime/trainer.py``).

Contract parity with the JAX trainer and the reference runtime
(cpu/trainer.py): epoch- or iteration-based single-optimizer loop, the loss
as a subclass extension point, default hooks [LRUpdate, Checkpoint (rank 0),
Logger (rank 0)], metric storage with window smoothing, NaN/Inf loss ->
FloatingPointError, ``epoch_{e}.pth`` + ``latest.pth`` checkpoints with a
strict=False model load and a device-count assert on resume.

The design keeps the JAX trainer's:
- the training arrays live on the device; each step gathers its rows with
  ``index_select`` by the epoch's indices, and the padding mask rides along;
- nothing syncs per step: the step enqueues forward, backward and the
  optimizer update, its losses stay device scalars in ``_pending``, and
  ``flush_metrics`` fetches them in one transfer (every ``log_period`` and
  at epoch end), where a non-finite loss raises FloatingPointError;
- the learning rate is a host float from the schedule, written into the
  optimizer's param groups each step.

Subclasses implement ``train_cal_loss(batch) -> (loss, loss_dict)``; the
batch dict holds the gathered rows plus ``mask`` (0 on padded rows).

Every forward outside the train step (evals, hooks) goes through
``model_apply``: eval mode under ``no_grad``, the model's mode restored
after, so no such forward updates BatchNorm running statistics or leaves
the model in eval mode for the next step.
"""

from __future__ import annotations

import logging
import math
import os
import os.path as osp
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.dist import get_rank, get_world_size, is_main_process
from .checkpoint import CheckpointManager, load_checkpoint_file, load_state_dict_strict_false
from .device import resolve_device
from .history import MetricStorage
from .hooks import CheckpointHook, HookBase, LoggerHook, LRUpdateHook
from .logger import setup_logger
from .misc import collect_env

__all__ = ["Trainer", "eval_forward", "masked_mse"]

logger = logging.getLogger("tactilesr_torch")


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MSE over valid rows only (padded final-batch rows carry mask 0).
    Equals ``nn.MSELoss()`` on the unpadded batch; an all-padded batch gives
    0 with zero gradients instead of 0/0."""
    pred = pred.float()
    target = target.float()
    m = mask.reshape((-1,) + (1,) * (pred.ndim - 1))
    per_elem = math.prod(pred.shape[1:])
    se = ((pred - target) ** 2 * m).sum()
    return se / torch.clamp(mask.sum() * per_elem, min=1.0)


def eval_forward(model: torch.nn.Module, *args, **kwargs):
    """``model(*args, **kwargs)`` in eval mode under ``no_grad``; the model
    goes back to the mode it was in."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(*args, **kwargs)
    finally:
        model.train(was_training)


class Trainer:
    """Epoch/iteration-based trainer over device-resident datasets."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer,
        lr_schedule,
        train_arrays: Dict[str, np.ndarray],
        batch_size: int,
        max_epochs: int = 0,
        max_iters: int = 0,
        work_dir: str = "work_dir",
        max_num_checkpoints: Optional[int] = None,
        checkpoint_period: int = 1,
        log_period: int = 50,
        seed: int = 42,
        scan_epochs: bool = False,
        remat: bool = False,
        grad_accum: int = 1,
        device="cuda",
    ):
        if scan_epochs:
            raise NotImplementedError(
                "scan_epochs is not ported (ROADMAP A5: a CUDA-graph-captured step)")
        if remat:
            raise NotImplementedError("remat is not ported (ROADMAP A5: activation checkpointing)")
        assert (max_epochs > 0) ^ (max_iters > 0), "specify either max_epochs or max_iters"
        assert grad_accum >= 1, "grad_accum must be >= 1"
        assert batch_size % grad_accum == 0, (
            f"batch_size ({batch_size}) must divide into grad_accum "
            f"({grad_accum}) micro-batches"
        )
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.work_dir = work_dir
        self.batch_size = batch_size
        self.grad_accum = int(grad_accum)
        self.metric_storage = MetricStorage()
        self._rng = np.random.default_rng(seed)

        self.train_by_epoch = max_epochs > 0
        self.n_train = next(iter(train_arrays.values())).shape[0]
        self.epoch_len = math.ceil(self.n_train / batch_size)
        if self.train_by_epoch:
            self.max_epochs = max_epochs
            self.max_iters = max_epochs * self.epoch_len
        else:
            self.max_epochs = 0
            self.max_iters = max_iters

        self.cur_iter = 0
        self.start_iter = 0
        self.step = 0  # optimizer steps taken

        self.device_arrays = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in train_arrays.items()
        }

        self._hooks: List[HookBase] = []
        self._pending: List[Tuple[int, Dict[str, torch.Tensor], float, float, float]] = []
        self._max_num_checkpoints = max_num_checkpoints
        self._checkpoint_period = checkpoint_period
        self._log_period = log_period
        self.ckpt_manager = CheckpointManager(self.ckpt_dir, max_num_checkpoints)
        self._default_setup()

    # ------------------------------------------------------------------ api
    @property
    def lr(self) -> float:
        return self.lr_schedule.get_lr()

    @property
    def inner_iter(self) -> int:
        assert self.train_by_epoch
        return self.cur_iter % self.epoch_len

    @property
    def cur_epoch(self) -> int:
        assert self.train_by_epoch
        return self.cur_iter // self.epoch_len

    @property
    def ckpt_dir(self) -> str:
        return osp.join(self.work_dir, "checkpoints")

    @property
    def tb_log_dir(self) -> str:
        return osp.join(self.work_dir, "tb_logs")

    @property
    def hook_info(self) -> List[str]:
        return [f"{h.class_name} (priority {h.priority})" for h in self._hooks]

    def log(self, *args, **kwargs) -> None:
        self.metric_storage.update(*args, **kwargs)

    def model_apply(self, *args, **kwargs):
        """Eval-mode forward of the current model (see ``eval_forward``)."""
        return eval_forward(self.model, *args, **kwargs)

    # ------------------------------------------------------------ internals
    def _default_setup(self) -> None:
        setup_logger("tactilesr_torch", output_dir=self.work_dir, process_index=get_rank())
        logger.info("Environment info:\n%s", collect_env())
        default_hooks: List[HookBase] = [LRUpdateHook()]
        if is_main_process():
            default_hooks += [
                CheckpointHook(self._checkpoint_period, self._max_num_checkpoints),
                LoggerHook(self._log_period, tb_log_dir=self.tb_log_dir),
            ]
        self.register_hooks(default_hooks)
        logger.info("Registered default hooks: %s", self.hook_info)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        logger.info("Work dir: %s | ckpt dir: %s | tb dir: %s",
                    self.work_dir, self.ckpt_dir, self.tb_log_dir)

    def register_hooks(self, hooks: List[HookBase]) -> None:
        for h in hooks:
            self.register_hook(h)

    def register_hook(self, hook: HookBase) -> None:
        assert isinstance(hook, HookBase)
        assert 1 <= hook.priority <= 10
        hook.trainer = weakref.proxy(self)
        for i in range(len(self._hooks) - 1, -1, -1):
            if hook.priority >= self._hooks[i].priority:
                self._hooks.insert(i + 1, hook)
                return
        self._hooks.insert(0, hook)

    def _call_hooks(self, stage: str) -> None:
        for h in self._hooks:
            getattr(h, stage)()

    # ------------------------------------------------------- the train step
    def train_cal_loss(self, batch: Dict[str, torch.Tensor]):
        """Subclass extension point.  Returns (loss, loss_dict)."""
        raise NotImplementedError("subclass the Trainer and implement train_cal_loss")

    def _gather(self, idx: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch = {k: v.index_select(0, idx) for k, v in self.device_arrays.items()}
        batch["mask"] = mask
        return batch

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":  # pinned, so the copy does not wait on the stream
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _step(self, idx: torch.Tensor, mask: torch.Tensor, lr: float,
              weights: np.ndarray) -> Dict[str, torch.Tensor]:
        """One optimizer step, enqueued without a host sync.

        With ``grad_accum`` K > 1 the batch is K micro-batches whose
        gradients are weighted by their valid-row counts (``weights``, known
        on the host from the mask), so for a mean-over-valid-rows loss the
        accumulated gradient equals the full-batch one, padded final batches
        included; an all-padded micro-batch is skipped and contributes
        nothing (nor updates any BatchNorm statistics)."""
        self.optimizer.zero_grad()
        if self.grad_accum == 1:
            loss, loss_dict = self.train_cal_loss(self._gather(idx, mask))
            loss.backward()
            loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        else:
            wtot = float(weights.sum())
            idx_m = idx.view(self.grad_accum, -1)
            mask_m = mask.view(self.grad_accum, -1)
            loss_dict = {}
            for k, w in enumerate(weights):
                if w == 0:
                    continue
                scale = float(w) / wtot
                loss, ld = self.train_cal_loss(self._gather(idx_m[k], mask_m[k]))
                (loss * scale).backward()
                for name, v in ld.items():
                    loss_dict[name] = loss_dict.get(name, 0.0) + v.detach() * scale
        self.optimizer.step(lr)
        self.step += 1
        return loss_dict

    def train_one_iter(self, idx: np.ndarray, mask: np.ndarray) -> None:
        iter_start = time.perf_counter()
        weights = mask.reshape(self.grad_accum, -1).sum(axis=1)
        idx_t = self._to_device(idx)
        mask_t = self._to_device(mask)
        data_time = time.perf_counter() - iter_start
        lr = float(self.lr)
        loss_dict = self._step(idx_t, mask_t, lr, weights)
        iter_time = time.perf_counter() - iter_start
        self._pending.append((self.cur_iter, loss_dict, data_time, iter_time, lr))

    def flush_metrics(self) -> None:
        """Fetch all pending device losses in one transfer; NaN-check."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        flat = torch.stack(
            [v.float() for p in pending for v in p[1].values()]).cpu().tolist()
        pos = 0
        for it, loss_dict, data_time, iter_time, lr in pending:
            metrics = dict(zip(loss_dict, flat[pos:pos + len(loss_dict)]))
            pos += len(loss_dict)
            total = sum(metrics.values())
            if not np.isfinite(total):
                raise FloatingPointError(
                    f"Loss became infinite or NaN at iteration={it}! loss_dict={metrics}."
                )
            if is_main_process():
                self.log(it, lr=lr, smooth=False)
                self.log(it, data_time=data_time)
                self.log(it, iter_time=iter_time)
                self.log(it, total_loss=total)
                if len(metrics) > 1:
                    self.log(it, **metrics)

    # --------------------------------------------------------------- loop
    def train(self, resume_from_checkpoint: Optional[str] = None, auto_resume: bool = True) -> None:
        if resume_from_checkpoint is not None:
            self.load_checkpoint(path=resume_from_checkpoint)
        else:
            self.load_checkpoint(auto_resume=auto_resume)

        logger.info("Start training from iteration %d", self.start_iter)
        self.model.train()
        self._call_hooks("before_train")
        epoch_iter = None
        for self.cur_iter in range(self.start_iter, self.max_iters):
            if self.train_by_epoch and self.cur_iter % self.epoch_len == 0:
                self._call_hooks("before_epoch")
                epoch_iter = self._epoch_batches()
            if epoch_iter is None:  # iter-based training
                epoch_iter = self._epoch_batches()
            self._call_hooks("before_iter")
            try:
                idx, mask = next(epoch_iter)
            except StopIteration:
                epoch_iter = self._epoch_batches()
                idx, mask = next(epoch_iter)
            self.train_one_iter(idx, mask)
            self._call_hooks("after_iter")
            if self.train_by_epoch and (self.cur_iter + 1) % self.epoch_len == 0:
                self.flush_metrics()
                self._call_hooks("after_epoch")
        self.flush_metrics()
        self._call_hooks("after_train")

    def _epoch_batches(self):
        from ..data.loader import epoch_batches

        return epoch_batches(self.n_train, self.batch_size, shuffle=True, rng=self._rng)

    # --------------------------------------------------------- checkpoints
    def save_checkpoint(self, file_name: str) -> None:
        self.flush_metrics()
        bundle: Dict[str, Any] = {
            "num_devices": get_world_size(),  # one device per process
            "num_processes": get_world_size(),
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "lr_scheduler": self.lr_schedule.state_dict(),
            "metric_storage": self.metric_storage.state_dict(),
            "step": self.step,
        }
        bundle.update({"epoch": self.cur_epoch} if self.train_by_epoch else {"iter": self.cur_iter})
        hook_states = {h.class_name: h.state_dict() for h in self._hooks if h.checkpointable}
        if hook_states:
            bundle["hooks"] = hook_states
        self.ckpt_manager.save(file_name, bundle)

    def load_checkpoint(self, path: Optional[str] = None, auto_resume: bool = False) -> None:
        if path is None and auto_resume:
            latest = self.ckpt_manager.latest_path()
            if latest is None:
                logger.warning("auto_resume=True but no latest checkpoint found in %s",
                               self.ckpt_dir)
            else:
                logger.info("Auto-resuming from %s", latest)
                path = latest
        if not path:
            logger.info("Skip loading checkpoint.")
            return
        logger.info("Loading checkpoint from %s ...", path)
        bundle = load_checkpoint_file(path)

        n_dev, ckpt_dev = get_world_size(), bundle["num_devices"]
        assert n_dev == ckpt_dev, (
            f"checkpoint was trained with {ckpt_dev} devices, but {n_dev} are present")

        if self.train_by_epoch:
            self.start_iter = (bundle["epoch"] + 1) * self.epoch_len
        else:
            self.start_iter = bundle["iter"] + 1

        missing, unexpected = load_state_dict_strict_false(self.model, bundle["model"])
        if missing:
            logger.warning("Missing keys when loading model weights:\n%s", missing)
        if unexpected:
            logger.warning("Unexpected keys when loading model weights:\n%s", unexpected)
        self.optimizer.load_state_dict(bundle["optimizer"])
        self.step = int(bundle.get("step", self.start_iter))
        self.metric_storage.load_state_dict(bundle["metric_storage"])
        self.lr_schedule.load_state_dict(bundle["lr_scheduler"])

        hook_states = bundle.get("hooks", {})
        hook_names = [h.class_name for h in self._hooks if h.checkpointable]
        for name in hook_names:
            if name not in hook_states:
                logger.warning("Missing hook state: %s", name)
        for key, value in hook_states.items():
            if key not in hook_names:
                logger.warning("Unexpected hook state: %s", key)
                continue
            for h in self._hooks:
                if h.class_name == key and h.checkpointable:
                    h.load_state_dict(value)
                    break
