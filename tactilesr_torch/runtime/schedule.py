"""Learning-rate schedules (the port's copy of
``tactilesr_tpu/runtime/schedule.py``).

Host-side state machines producing one float per iteration; the trainer
writes it into the optimizer's ``param_groups`` before each step.  The
warmup wrapper reproduces the reference
semantics exactly (cpu/lr_scheduler.py:6-182): modes "fix"/"factor"/"auto",
pre-computed post-warmup regular LRs, by-iter or by-epoch warmup, and the
subtlety that epochs fully covered by warmup do NOT advance the inner
scheduler (the pre-compute already advanced it ``max_t`` steps).

The training recipes use StepLR inners (config: step_size 1-2, gamma 0.8) and
the tactileSR recipe uses warmup_t=2000 iters, mode "auto", factor 1e-4
(reference config/default.py:57-61; NB the entry script does not pass
``warmup_by_epoch``, so it defaults False despite the config dict -- we
reproduce the code path, train/tactileSR_train.py:224-227).
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["StepLR", "ConstantLR", "ReduceLROnPlateau", "LRWarmupSchedule"]


class StepLR:
    """lr(t) = base_lr * gamma ** (t // step_size); t advances via step()."""

    def __init__(self, base_lr: float, step_size: int, gamma: float = 0.1):
        self.base_lr = float(base_lr)
        self.step_size = int(step_size)
        self.gamma = float(gamma)
        self.t = 0

    @property
    def lr(self) -> float:
        return self.base_lr * self.gamma ** (self.t // self.step_size)

    def lr_at(self, t: int) -> float:
        return self.base_lr * self.gamma ** (t // self.step_size)

    def step(self, metric: Optional[float] = None) -> None:
        self.t += 1

    def state_dict(self) -> dict:
        return {"t": self.t, "base_lr": self.base_lr}

    def load_state_dict(self, state: dict) -> None:
        self.t = int(state["t"])


class ConstantLR:
    def __init__(self, base_lr: float):
        self.base_lr = float(base_lr)
        self.t = 0

    @property
    def lr(self) -> float:
        return self.base_lr

    def step(self, metric: Optional[float] = None) -> None:
        self.t += 1

    def state_dict(self) -> dict:
        return {"t": self.t}

    def load_state_dict(self, state: dict) -> None:
        self.t = int(state["t"])


class ReduceLROnPlateau:
    """Plateau scheduler (torch-compatible semantics, 'min'/'max' mode,
    'rel'/'abs' threshold).  Dynamic: cannot be table-precomputed."""

    is_plateau = True

    def __init__(
        self,
        base_lr: float,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
        min_lr: float = 0.0,
    ):
        assert mode in ("min", "max") and threshold_mode in ("rel", "abs")
        self.base_lr = float(base_lr)
        self._lr = float(base_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.t = 0

    @property
    def lr(self) -> float:
        return self._lr

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            thr = (
                self.best * (1 - self.threshold)
                if self.threshold_mode == "rel"
                else self.best - self.threshold
            )
            return metric < thr
        thr = (
            self.best * (1 + self.threshold)
            if self.threshold_mode == "rel"
            else self.best + self.threshold
        )
        return metric > thr

    def step(self, metric: Optional[float] = None) -> None:
        self.t += 1
        if metric is None:
            return
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self._lr = max(self._lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0

    def state_dict(self) -> dict:
        return {
            "lr": self._lr,
            "best": self.best,
            "num_bad": self.num_bad,
            "cooldown_counter": self.cooldown_counter,
            "t": self.t,
        }

    def load_state_dict(self, state: dict) -> None:
        self._lr = float(state["lr"])
        self.best = state["best"]
        self.num_bad = int(state["num_bad"])
        self.cooldown_counter = int(state["cooldown_counter"])
        self.t = int(state["t"])


class LRWarmupSchedule:
    """Warmup wrapper over an inner scheduler; ``get_lr()`` is the LR to use
    for the *next* optimizer step.  Call ``iter_update()`` after each
    iteration and ``epoch_update(metric)`` after each epoch, mirroring the
    reference trainer's hook call pattern."""

    def __init__(
        self,
        inner,
        by_epoch: bool = True,
        epoch_len: Optional[int] = None,
        warmup_t: int = 0,
        warmup_by_epoch: bool = False,
        warmup_mode: str = "fix",
        warmup_init_lr: Optional[float] = None,
        warmup_factor: Optional[float] = None,
    ):
        self.inner = inner
        self.by_epoch = by_epoch
        self.epoch_len = epoch_len
        self.warmup_t = warmup_t
        self.warmup_by_epoch = warmup_by_epoch
        self.warmup_mode = warmup_mode
        self.warmup_init_lr = warmup_init_lr
        self.warmup_factor = warmup_factor
        self._is_plateau = getattr(inner, "is_plateau", False)

        if warmup_by_epoch:
            assert by_epoch
        if by_epoch and warmup_t and not warmup_by_epoch:
            assert epoch_len is not None, "epoch_len required for by-iter warmup"
        if self._is_plateau:
            assert by_epoch

        self.base_lr = inner.base_lr
        self.regular_lrs_per_t: List[float] = []
        if warmup_t:
            max_t = (
                warmup_t // epoch_len
                if by_epoch and not warmup_by_epoch
                else warmup_t
            )
            if self._is_plateau:
                self.regular_lrs_per_t = [self.base_lr] * (max_t + 1)
            else:
                # pre-step the inner scheduler max_t times; it stays advanced
                self.regular_lrs_per_t = [inner.lr]
                for _ in range(max_t):
                    inner.step()
                    self.regular_lrs_per_t.append(inner.lr)

        self.last_iter = 0
        self.last_epoch = 0
        self.in_iter_warmup = False

        if warmup_t > 0:
            if warmup_mode == "fix":
                assert isinstance(warmup_init_lr, float)
                self._lr = warmup_init_lr
            elif warmup_mode == "factor":
                assert isinstance(warmup_factor, float)
                self._lr = self.base_lr * warmup_factor
            elif warmup_mode == "auto":
                assert isinstance(warmup_factor, float)
                self.warmup_end_lr = self.regular_lrs_per_t[-1]
                self._lr = self.base_lr * warmup_factor
            else:
                raise ValueError(f"Invalid warmup mode: {warmup_mode}")
        else:
            self._lr = inner.lr

    def get_lr(self) -> float:
        return self._lr

    def _warmup_lr(self, t: int, regular_lr: float) -> float:
        alpha = t / self.warmup_t
        if self.warmup_mode == "fix":
            return self.warmup_init_lr * (1 - alpha) + self.base_lr * alpha
        if self.warmup_mode == "factor":
            factor = self.warmup_factor * (1 - alpha) + alpha
            return regular_lr * factor
        return self.base_lr * self.warmup_factor * (1 - alpha) + self.warmup_end_lr * alpha

    def iter_update(self) -> None:
        if self.warmup_by_epoch:
            return
        self.last_iter += 1
        if self.last_iter < self.warmup_t:
            self.in_iter_warmup = True
            t = self.last_iter // self.epoch_len if self.by_epoch else self.last_iter
            self._lr = self._warmup_lr(self.last_iter, self.regular_lrs_per_t[t])
        elif self.last_iter == self.warmup_t:
            self._lr = self.regular_lrs_per_t[-1]
        else:
            self.in_iter_warmup = False
            if not self.by_epoch:
                self.inner.step()
                self._lr = self.inner.lr

    def epoch_update(self, metric: Optional[float] = None) -> None:
        if not self.by_epoch:
            return
        self.last_epoch += 1
        if self.warmup_by_epoch and self.last_epoch < self.warmup_t:
            self._lr = self._warmup_lr(
                self.last_epoch, self.regular_lrs_per_t[self.last_epoch]
            )
        elif self.warmup_by_epoch and self.last_epoch == self.warmup_t:
            self._lr = self.regular_lrs_per_t[-1]
        elif not self.in_iter_warmup:
            self.inner.step(metric)
            self._lr = self.inner.lr

    def state_dict(self) -> dict:
        state = {
            "last_iter": self.last_iter,
            "last_epoch": self.last_epoch,
            "in_iter_warmup": self.in_iter_warmup,
            "lr": self._lr,
            "inner": self.inner.state_dict(),
        }
        return state

    def load_state_dict(self, state: dict) -> None:
        self.last_iter = int(state["last_iter"])
        self.last_epoch = int(state["last_epoch"])
        self.in_iter_warmup = bool(state["in_iter_warmup"])
        self._lr = float(state["lr"])
        self.inner.load_state_dict(state["inner"])
