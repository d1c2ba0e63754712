"""The recipes' optimizer: Adam with coupled L2 weight decay (the port of
``tactilesr_tpu/runtime/optim.py::adam_l2``).

``torch.optim.Adam(weight_decay=wd)`` adds ``wd * param`` to the gradient
before the moment updates, which is the optax chain
``add_decayed_weights -> scale_by_adam`` of the JAX package.  The learning
rate comes from the host-side schedule: ``step(lr)`` writes it into every
param group before stepping, as the JAX trainer feeds it to its jitted step.
An optional global-norm clip runs first, through ``clip_grad_norm_``; it
scales by ``max_norm / (norm + 1e-6)`` where optax's
``clip_by_global_norm`` scales by ``max_norm / norm``.
"""

from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["AdamL2", "adam_l2"]


class AdamL2:
    """``torch.optim.Adam`` plus the clip and the per-step learning rate."""

    def __init__(self, params: Iterable[torch.nn.Parameter], weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 clip_grad_norm: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        # lr is a placeholder: step() writes the schedule's value each step
        self.optimizer = torch.optim.Adam(self.params, lr=0.0, betas=(b1, b2), eps=eps,
                                          weight_decay=weight_decay)
        self.clip_grad_norm = float(clip_grad_norm or 0.0)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, lr: float) -> None:
        if self.clip_grad_norm > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip_grad_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state)


def adam_l2(params, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8, clip_grad_norm: float = 0.0) -> AdamL2:
    """torch-Adam with coupled L2 over ``params``, learning rate per step."""
    return AdamL2(params, weight_decay, b1, b2, eps, clip_grad_norm)
