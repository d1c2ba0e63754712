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

``scan_epochs`` is the counterpart of the JAX trainer's whole-epoch
``lax.scan``: each epoch puts its (idx, mask, lr) rows on the device once,
into fixed buffers, and a device step counter picks each step's row.  The
step (``_scan_step``: gather, forward, backward, Adam, the loss written to a
per-step buffer, the counter advanced) issues no host sync, so on CUDA it
is captured once in a ``torch.cuda.CUDAGraph`` and every later step is one
replay; an epoch ends with one fetch of its losses.  The first
``SCAN_WARMUP_STEPS`` steps run eagerly, on a side stream, as the epoch's
own steps (cuDNN picks its algorithms and Adam builds its state there),
then the capture follows; a failed capture or replay raises.  Scan mode on
CUDA makes the optimizer capturable (learning rate and Adam's step
counters on the device, the update one kernel launch,
``ops/cuda/adam.py``); the eager loop keeps the host-side form.  On the CPU
the same step function runs uncaptured through the same buffers.  Only the
epoch hooks fire in this mode, as in JAX.  While a torch profiler runs, an
epoch records its phases as spans (``runtime/tracing.py``):
``trainer.epoch`` around ``trainer.prepare`` (the order, the learning rates
and the buffer copies), ``trainer.replays`` (the steps), ``trainer.fetch``
(the losses) and ``trainer.log``.  ``trainer.replays`` carries, besides
its eager and captured steps, ``launches``: what each counter registered
with ``ops/graph.py::register_counters`` gained over the steps, replays
included (the physics kernels' launches, for a tPSFNet; the optimizer
kernel's, ``adam_l2``, in every captured step).

On CUDA the model's 4-D parameters are channels-last (``models/layers.py``
``memory_format``), so the SR networks' activations stay NHWC from conv to
BatchNorm to conv; Adam's state follows its parameters' layout (a resume
converts it, ``runtime/optim.py``).  Checkpoints, ``state_digest`` and the
gradient ``all_reduce`` read tensors in logical order, whatever their
layout.

``remat`` runs the forward and loss under activation checkpointing; the
recompute's second BatchNorm update is undone, so the running statistics
and counters are those of one forward, as ``jax.checkpoint`` leaves them.

``mesh`` (``parallel/mesh.py``) trains data-parallel, one process per
device, as the JAX trainer does over a mesh's data axis: every rank holds
the whole dataset, draws the same seeded epoch order and takes its
contiguous block of rows of each (micro-)batch.  Each rank's loss is a
mean over its valid rows; its gradients enter the sum weighted by its
valid-row count over the global batch's (known on the host, or from the
mask on the device), so the summed gradient is the global batch's, padded
final batches included, however their valid rows fall on the ranks.  One
``all_reduce`` of one flat buffer per optimizer step sums the gradients
and the loss values.  On a mesh of more than one rank the trainer sets
``sync`` on the model's BatchNorm layers, which then take their statistics
over the global batch (``models/layers.py``).  Every rank steps the same optimizer on the same
sums, so the replicas stay equal.  Under NCCL the captured step records
the collective and replays it; gloo's collectives cannot be captured, so
``scan_epochs`` on CUDA under gloo raises.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
import os.path as osp
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.layers import BatchNorm, memory_format
from ..ops.graph import CapturedGraph, counter_totals
from ..parallel.dist import get_rank, get_world_size, is_main_process
from ..parallel.mesh import shard_batch_size
from . import tracing
from .checkpoint import CheckpointManager, load_checkpoint_file, load_state_dict_strict_false
from .device import resolve_device
from .history import MetricStorage
from .hooks import CheckpointHook, HookBase, LoggerHook, LRUpdateHook
from .logger import setup_logger
from .misc import collect_env

__all__ = ["Trainer", "eval_forward", "masked_mse"]

logger = logging.getLogger("tactilesr_torch")

# eager steps of the scan path before its capture (torch.cuda.graphs asks for
# a few, for cuDNN's algorithm choice and the optimizer's lazy state)
SCAN_WARMUP_STEPS = 3


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


class _ScanBuffers:
    """The scan path's fixed device storage: one epoch's (idx, mask, lr)
    rows, the counter that picks a step's row, and each loss's per-step
    values.  Allocated once; every epoch copies into the same storage, so a
    captured step reads and writes the addresses its capture saw."""

    def __init__(self, steps: int, batch: int, device: torch.device):
        self.idx = torch.zeros((steps, batch), dtype=torch.int64, device=device)
        self.mask = torch.zeros((steps, batch), dtype=torch.float32, device=device)
        self.lr = torch.zeros(steps, dtype=torch.float32, device=device)
        self.k = torch.zeros(1, dtype=torch.int64, device=device)
        self.losses: Dict[str, torch.Tensor] = {}


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
        mesh=None,
    ):
        assert (max_epochs > 0) ^ (max_iters > 0), "specify either max_epochs or max_iters"
        assert not (scan_epochs and max_iters > 0), "scan_epochs requires epoch-based training"
        assert grad_accum >= 1, "grad_accum must be >= 1"
        assert batch_size % grad_accum == 0, (
            f"batch_size ({batch_size}) must divide into grad_accum "
            f"({grad_accum}) micro-batches"
        )
        if mesh is not None:
            # under accumulation the micro-batch is what lands on the ranks
            shard_batch_size(batch_size // grad_accum, mesh)
            if not (torch.distributed.is_initialized() and not mesh.devices
                    and mesh.size == get_world_size()):
                raise ValueError(
                    f"a training mesh spans the process group (parallel.init_distributed), one "
                    f"device per process: got {mesh} in a world of {get_world_size()}")
        self.mesh = mesh
        self.device = resolve_device(device)
        # channels-last on CUDA: each conv and BatchNorm then reads and writes
        # NHWC activations, with no transpose around cuDNN's NHWC kernels
        self.model = model.to(self.device, memory_format=memory_format(self.device))
        for m in model.modules():  # global-batch statistics across the ranks
            if isinstance(m, BatchNorm):
                m.sync = mesh is not None and mesh.size > 1
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.work_dir = work_dir
        self.batch_size = batch_size
        self.grad_accum = int(grad_accum)
        self.scan_epochs = scan_epochs
        self.remat = remat
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

        self._scan: Optional[_ScanBuffers] = None
        self._graph: Optional[CapturedGraph] = None
        self._warm_steps = 0

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

    def state_digest(self) -> str:
        """One sha256 of the model's state and the optimizer's: equal on
        every replica of a data-parallel run."""
        h = hashlib.sha256()
        tensors = list(self.model.state_dict().items())
        for i, st in sorted(self.optimizer.state_dict()["state"].items()):
            tensors += [(f"optimizer.{i}.{k}", torch.as_tensor(v)) for k, v in sorted(st.items())]
        for k, v in tensors:
            h.update(k.encode())
            h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

    @property
    def _num_devices(self) -> int:
        """The data-axis size: what a checkpoint records and a resume asserts."""
        return 1 if self.mesh is None else self.mesh.size

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

    def _bn_state(self) -> List[torch.Tensor]:
        """The BatchNorm running statistics and counters: what a train-mode
        forward updates besides its output."""
        out = []
        for m in self.model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm) and m.track_running_stats:
                out += [m.running_mean, m.running_var, m.num_batches_tracked]
        return out

    def _loss_and_grads(self, batch: Dict[str, torch.Tensor], scale=None, params=None):
        """Forward, loss and backward of one (micro-)batch -> (detached
        loss_dict, grads).  With ``params`` None, ``loss`` (times ``scale``,
        a float or a device scalar, where given) is backpropagated into
        ``.grad`` (grads None); else the loss's
        gradients for ``params`` are returned (None for an unused one).

        Under ``remat`` the forward and loss run in
        ``torch.utils.checkpoint`` (non-reentrant, no RNG state: the step
        draws no random numbers, and reading the CUDA generator is not
        allowed in a graph capture); the backward's recompute updates BN a
        second time, so the state the first forward left is put back."""
        if self.remat:
            loss, loss_dict = torch.utils.checkpoint.checkpoint(
                self.train_cal_loss, batch, use_reentrant=False, preserve_rng_state=False)
            bn = self._bn_state()
            kept = [b.clone() for b in bn]
        else:
            loss, loss_dict = self.train_cal_loss(batch)
        grads = None
        if params is None:
            (loss if scale is None else loss * scale).backward()
        else:
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        if self.remat:
            for b, v in zip(bn, kept):
                b.copy_(v)
        return {k: v.detach() for k, v in loss_dict.items()}, grads

    def _shard(self, rows):
        """This rank's contiguous block of the last axis of ``rows`` (a
        (micro-)batch's indices or mask, tensor or array); all of it without
        a mesh."""
        if self.mesh is None:
            return rows
        b = rows.shape[-1] // self.mesh.size
        return rows[..., self.mesh.rank * b:(self.mesh.rank + 1) * b]

    def _all_reduce(self, loss_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Sum every rank's gradients (in ``.grad``) and weighted loss values
        with one ``all_reduce`` of one flat f32 buffer; returns the summed
        losses."""
        grads = [p.grad for p in self.optimizer.params if p.grad is not None]
        names = list(loss_dict)
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss_dict[n].float().reshape(1) for n in names])
        torch.distributed.all_reduce(flat)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return {n: flat[off + i] for i, n in enumerate(names)}

    def _step(self, idx: torch.Tensor, mask: torch.Tensor, lr: float,
              weights: np.ndarray, local: np.ndarray) -> Dict[str, torch.Tensor]:
        """One optimizer step, enqueued without a host sync.

        With ``grad_accum`` K > 1 or a mesh, the batch is K micro-batches
        (each split over the ranks) whose gradients are weighted by the
        valid-row counts of this rank's block (``local``) over the whole
        batch's (``weights`` per micro-batch; both known on the host from
        the mask), so for a mean-over-valid-rows loss the accumulated
        gradient, summed over the ranks, equals the full-batch one, padded
        final batches included; an all-padded micro-batch is skipped by
        every rank and contributes nothing (nor updates any BatchNorm
        statistics)."""
        self.optimizer.zero_grad()
        if self.grad_accum == 1 and self.mesh is None:
            loss_dict, _ = self._loss_and_grads(self._gather(idx, mask))
        else:
            wtot = float(weights.sum())
            idx_m = self._shard(idx.view(self.grad_accum, -1))
            mask_m = self._shard(mask.view(self.grad_accum, -1))
            loss_dict = {}
            for k, (w, wl) in enumerate(zip(weights, local)):
                if w == 0:
                    continue
                scale = float(wl) / wtot
                ld, _ = self._loss_and_grads(self._gather(idx_m[k], mask_m[k]), scale)
                for name, v in ld.items():
                    loss_dict[name] = loss_dict.get(name, 0.0) + v * scale
            if self.mesh is not None:
                loss_dict = self._all_reduce(loss_dict)
        self.optimizer.step(lr)
        self.step += 1
        return loss_dict

    def _accumulate_on_device(self, idx: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``grad_accum`` K > 1 micro-batches with the weights computed from
        the mask on the device, as the JAX step's inner scan does: a graph
        cannot skip an all-padded micro-batch on the host, so it selects
        instead.  Each micro-batch's gradients enter
        the sum as ``where(w > 0, w g, 0)`` with w the valid rows of this
        rank's block (a loss may be NaN on padding, and NaN * 0 stays NaN),
        and BN's state goes back to its value before the micro-batch where
        the whole micro-batch is padding.  The sum over the batch's valid
        rows is then divided out, ``.grad`` set from it, and the ranks'
        shares summed."""
        K = self.grad_accum
        idx_m, mask_m = self._shard(idx.view(K, -1)), self._shard(mask.view(K, -1))
        keep_m = mask.view(K, -1).sum(dim=1) > 0
        w = mask_m.sum(dim=1)
        wtot = mask.sum()
        params = self.optimizer.params
        gsum: List[Optional[torch.Tensor]] = [None] * len(params)
        bn = self._bn_state()
        loss_dict: Dict[str, torch.Tensor] = {}
        for k in range(K):
            keep, own = keep_m[k], w[k] > 0
            before = [b.clone() for b in bn]
            ld, grads = self._loss_and_grads(self._gather(idx_m[k], mask_m[k]), params=params)
            for b, old in zip(bn, before):
                b.copy_(torch.where(keep, b, old))
            for i, g in enumerate(grads):
                if g is not None:
                    g = torch.where(own, w[k] * g.float(), 0.0)
                    gsum[i] = g if gsum[i] is None else gsum[i].add_(g)
            for name, v in ld.items():
                v = torch.where(own, w[k] * v.float(), 0.0)
                loss_dict[name] = v if name not in loss_dict else loss_dict[name] + v
        for p, g in zip(params, gsum):
            if g is not None:
                p.grad = (g / wtot).to(p.dtype)
        loss_dict = {name: v / wtot for name, v in loss_dict.items()}
        return loss_dict if self.mesh is None else self._all_reduce(loss_dict)

    def _scan_step(self) -> None:
        """One optimizer step of the scan path, all on the device: the row
        at the step counter, the step, its losses into their per-step
        buffers, the counter advanced.  A CUDA graph captures exactly this;
        on the CPU it runs as it is."""
        s = self._scan
        idx = s.idx.index_select(0, s.k)[0]
        mask = s.mask.index_select(0, s.k)[0]
        self.optimizer.zero_grad()
        if self.grad_accum > 1:
            loss_dict = self._accumulate_on_device(idx, mask)
        elif self.mesh is None:
            loss_dict, _ = self._loss_and_grads(self._gather(idx, mask))
        else:  # this rank's share of the global mean; masked_mse gives 0 on no valid rows
            local = self._shard(mask)
            scale = local.sum() / mask.sum()
            ld, _ = self._loss_and_grads(self._gather(self._shard(idx), local), scale)
            loss_dict = self._all_reduce({name: v * scale for name, v in ld.items()})
        self.optimizer.step(s.lr.index_select(0, s.k)[0])
        for name, v in loss_dict.items():
            if name not in s.losses:
                s.losses[name] = torch.zeros(self.epoch_len, dtype=torch.float32, device=self.device)
            s.losses[name].index_copy_(0, s.k, v.float().view(1))
        s.k.add_(1)

    def _scan_one(self) -> None:
        """Run the next step of the scan path: uncaptured on the CPU; on
        CUDA eagerly on a side stream for the first ``SCAN_WARMUP_STEPS``,
        then captured once and replayed from then on."""
        if self.device.type != "cuda":
            self._scan_step()
        elif self._graph is not None:
            self._graph.replay()
        elif self._warm_steps < SCAN_WARMUP_STEPS:
            self._warm_steps += 1
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._scan_step()
            main.wait_stream(side)
        else:
            graph = CapturedGraph()
            self.optimizer.zero_grad()
            with graph.capture():
                self._scan_step()
            self._graph = graph
            logger.info("Captured the train step in a CUDA graph (kernel launches per replay: %s)",
                        {k: n for k, n in graph.per_replay.items() if n})
            self._scan_one()

    def _epoch_lrs(self, steps: int) -> np.ndarray:
        """Per-step learning rates of the coming epoch, advancing the real
        schedule as per-iteration training would (iter_update per step)."""
        lrs = np.empty(steps, np.float32)
        for k in range(steps):
            lrs[k] = self.lr_schedule.get_lr()
            self.lr_schedule.iter_update()
        return lrs

    def train_one_epoch_scan(self) -> None:
        """One epoch of the scan path: its rows into the fixed buffers,
        ``epoch_len`` steps, one fetch of the losses, then each step logged
        as the JAX trainer logs it (``iter_time`` the epoch's time over its
        steps, ``data_time`` 0)."""
        epoch_start = time.perf_counter()
        with tracing.span("trainer.epoch", steps=self.epoch_len):
            with tracing.span("trainer.prepare"):
                pairs = list(self._epoch_batches())
                idxs = np.stack([p[0] for p in pairs]).astype(np.int64)
                masks = np.stack([p[1] for p in pairs])
                steps = idxs.shape[0]
                base_iter = self.cur_iter
                lrs = self._epoch_lrs(steps)
                if self._scan is None:
                    self._scan = _ScanBuffers(self.epoch_len, self.batch_size, self.device)
                s = self._scan
                s.idx.copy_(torch.from_numpy(idxs))
                s.mask.copy_(torch.from_numpy(masks))
                s.lr.copy_(torch.from_numpy(lrs))
                s.k.zero_()
            with tracing.span("trainer.replays") as replays:
                warm, uncaptured = self._warm_steps, self._graph is None
                before = counter_totals() if replays.recording else None
                for _ in range(steps):
                    self._scan_one()
                    self.step += 1
                # eager: the steps run without the graph (every step on the CPU)
                replays.set(eager=steps if self.device.type != "cuda" else self._warm_steps - warm,
                            captured=int(uncaptured and self._graph is not None))
                if before is not None:
                    replays.set(launches={k: n - before.get(k, 0) for k, n in counter_totals().items()})
            with tracing.span("trainer.fetch"):
                fetched = {name: buf.cpu().tolist() for name, buf in s.losses.items()}
            per_step = (time.perf_counter() - epoch_start) / steps
            with tracing.span("trainer.log"):
                for k in range(steps):
                    it = base_iter + k
                    metrics = {name: vals[k] for name, vals in fetched.items()}
                    total = sum(metrics.values())
                    if not np.isfinite(total):
                        raise FloatingPointError(
                            f"Loss became infinite or NaN at iteration={it}! loss_dict={metrics}."
                        )
                    if is_main_process():
                        self.log(it, lr=float(lrs[k]), smooth=False)
                        self.log(it, data_time=0.0)
                        self.log(it, iter_time=per_step)
                        self.log(it, total_loss=total)
                        if len(metrics) > 1:
                            self.log(it, **metrics)

    def train_one_iter(self, idx: np.ndarray, mask: np.ndarray) -> None:
        iter_start = time.perf_counter()
        weights = mask.reshape(self.grad_accum, -1).sum(axis=1)
        local = self._shard(mask.reshape(self.grad_accum, -1)).sum(axis=1)
        idx_t = self._to_device(idx)
        mask_t = self._to_device(mask)
        data_time = time.perf_counter() - iter_start
        lr = float(self.lr)
        loss_dict = self._step(idx_t, mask_t, lr, weights, local)
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

        self.model.train()
        if self.scan_epochs:
            self._train_scan()
            return
        logger.info("Start training from iteration %d", self.start_iter)
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
        self._sync_ranks()

    def _sync_ranks(self) -> None:
        """Under a mesh, wait until every rank has finished training, so
        that rank 0's last checkpoint is on disk when any rank returns (a
        resume that follows reads it)."""
        if self.mesh is not None:
            torch.distributed.barrier()

    def _train_scan(self) -> None:
        """The epoch loop of the scan path (the JAX trainer's epoch-scan
        branch): only the epoch hooks fire, and a resume must land on an
        epoch boundary."""
        assert self.train_by_epoch, "scan_epochs requires epoch-based training"
        logger.info("Start training (epoch-scan mode) from iteration %d", self.start_iter)
        assert self.start_iter % self.epoch_len == 0, (
            "epoch-scan resume must land on an epoch boundary")
        if self.device.type == "cuda" and self.mesh is not None \
                and torch.distributed.get_backend() != "nccl":
            raise RuntimeError(
                f"scan_epochs on CUDA captures the train step in a CUDA graph, and the "
                f"{torch.distributed.get_backend()} backend's all_reduce cannot be captured; "
                "train data-parallel on CUDA under nccl, or with scan_epochs false")
        if self.device.type == "cuda" and not self.optimizer.capturable:
            self.optimizer.make_capturable()
        self._call_hooks("before_train")
        for epoch in range(self.start_iter // self.epoch_len, self.max_epochs):
            self.cur_iter = epoch * self.epoch_len
            self._call_hooks("before_epoch")
            self.train_one_epoch_scan()
            self.cur_iter = (epoch + 1) * self.epoch_len - 1
            self._call_hooks("after_epoch")
        self._call_hooks("after_train")
        self._sync_ranks()

    def _epoch_batches(self):
        from ..data.loader import epoch_batches

        return epoch_batches(self.n_train, self.batch_size, shuffle=True, rng=self._rng)

    # --------------------------------------------------------- checkpoints
    def save_checkpoint(self, file_name: str) -> None:
        self.flush_metrics()
        bundle: Dict[str, Any] = {
            "num_devices": self._num_devices,
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

        n_dev, ckpt_dev = self._num_devices, bundle["num_devices"]
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
        # the optimizer's state tensors are new: a captured step is captured again
        self._graph, self._warm_steps = None, 0
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
