"""Host-side training event bus (the port's copy of
``tactilesr_tpu/runtime/hooks/hookbase.py``).

Capability parity with the reference hook system (cpu/hooks/hookbase.py):
six lifecycle methods, integer priority 1-10 (lower runs earlier; insertion
keeps registration order within a priority), a weak reference to the trainer,
``checkpointable`` detection via state_dict presence, and the every-N /
is-last helpers the concrete hooks rely on.

Hooks observe the trainer's host state (metrics flushed from the device,
epoch/iter counters) and drive host actions (checkpoint IO, eval dispatch,
logging); none of them reads a device value per step.
"""

from __future__ import annotations

__all__ = ["HookBase"]


class HookBase:
    priority: int = 5
    trainer = None  # weakref.proxy set at registration

    # -- lifecycle ---------------------------------------------------------
    def before_train(self) -> None: ...

    def after_train(self) -> None: ...

    def before_epoch(self) -> None: ...

    def after_epoch(self) -> None: ...

    def before_iter(self) -> None: ...

    def after_iter(self) -> None: ...

    # -- utilities ---------------------------------------------------------
    @property
    def class_name(self) -> str:
        return self.__class__.__name__

    @property
    def checkpointable(self) -> bool:
        return callable(getattr(self, "state_dict", None))

    def every_n_epochs(self, n: int) -> bool:
        return (self.trainer.cur_epoch + 1) % n == 0 if n > 0 else False

    def every_n_iters(self, n: int) -> bool:
        return (self.trainer.cur_iter + 1) % n == 0 if n > 0 else False

    def every_n_inner_iters(self, n: int) -> bool:
        return (self.trainer.inner_iter + 1) % n == 0 if n > 0 else False

    def is_last_epoch(self) -> bool:
        return self.trainer.cur_epoch == self.trainer.max_epochs - 1

    def is_last_iter(self) -> bool:
        return self.trainer.cur_iter == self.trainer.max_iters - 1

    def is_last_inner_iter(self) -> bool:
        return self.trainer.inner_iter == self.trainer.epoch_len - 1
