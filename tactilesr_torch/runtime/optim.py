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

A CUDA graph of the train step needs torch's capturable Adam, which the
trainer asks for in scan mode on CUDA (``make_capturable``): each group's
learning rate becomes a 0-dim f32 tensor on the parameters' device, which
``step`` fills from a float or a device scalar, and Adam's step counters
move there, so the bias corrections are computed on the device in f32 (as
optax computes them) where the host-side form computes them in double.
The eager loop keeps the host-side form, which issues fewer device ops
per step; the two forms' losses part by rounding (a bf16 stage-1 run of 58
steps: 1.36e-3 relative on an H100).  On the CPU, where torch has no
capturable Adam, the learning rate stays a float.  ``state_dict`` always
writes the plain form (float learning rate, not capturable), so a
checkpoint loads on either device.
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
        self.capturable = False

    def make_capturable(self) -> None:
        """Switch to torch's capturable Adam (CUDA parameters only): the
        learning rate becomes a device tensor and the step counters move to
        the device, so a step issues no host sync and can be captured."""
        dev = self.params[0].device
        if dev.type != "cuda":
            raise ValueError(f"capturable Adam needs CUDA parameters, not {dev}")
        for group in self.optimizer.param_groups:
            group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32, device=dev)
            group["capturable"] = True
        for state in self.optimizer.state.values():
            if "step" in state:
                state["step"] = state["step"].to(dev, torch.float32)
        self.capturable = True

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, lr) -> None:
        """One Adam step at ``lr``: a float, or a 0-dim tensor (a capturable
        optimizer copies a device one on the device)."""
        if self.clip_grad_norm > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip_grad_norm)
        for group in self.optimizer.param_groups:
            if self.capturable:
                group["lr"].fill_(lr)
            else:
                group["lr"] = float(lr)
        self.optimizer.step()

    def state_dict(self) -> dict:
        sd = self.optimizer.state_dict()
        for group in sd["param_groups"]:
            group["lr"] = float(group["lr"])
            group["capturable"] = False
        return sd

    def load_state_dict(self, state: dict) -> None:
        """Load a state; a capturable optimizer stays capturable (with new
        lr and state tensors, so a captured step must be captured again)."""
        self.optimizer.load_state_dict(state)
        if self.capturable:
            self.make_capturable()


def adam_l2(params, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8, clip_grad_norm: float = 0.0) -> AdamL2:
    """torch-Adam with coupled L2 over ``params``, learning rate per step."""
    return AdamL2(params, weight_decay, b1, b2, eps, clip_grad_norm)
