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

A CUDA graph of the train step needs a capturable optimizer, which the
trainer asks for in scan mode on CUDA (``make_capturable``): each group's
learning rate becomes a 0-dim f32 tensor on the parameters' device, which
``step`` fills from a float or a device scalar, and Adam's step counters
move there, so the bias corrections are computed on the device in f32 (as
optax computes them) where the host-side form computes them in double.  A
capturable optimizer steps through one hand-written kernel per param group
(``ops/cuda/adam.py::adam_l2_update``: torch's capturable Adam's
arithmetic, in one launch where torch's foreach form issues a few hundred),
on torch's own state (``optimizer.state[p]``: ``step``, ``exp_avg``,
``exp_avg_sq``), which it creates as torch's capturable Adam does.  The
eager loop keeps the host-side form (``torch.optim.Adam``); the two forms'
losses part by rounding (a bf16 stage-1 run of 58 steps: 1.36e-3 relative
on an H100).  On the CPU, where torch has no capturable Adam, the learning
rate stays a float.  ``state_dict`` always writes the plain form (float
learning rate, not capturable), so a checkpoint loads on either device and
in either form.
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..ops.cuda.adam import adam_l2_update

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
        self._ticket = None  # the kernel's counter of finished blocks

    def make_capturable(self) -> None:
        """Step through the optimizer kernel (CUDA parameters only): the
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
        if self._ticket is None:
            self._ticket = torch.zeros(1, dtype=torch.int32, device=dev)
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
        if self.capturable:
            self._kernel_step()
        else:
            self.optimizer.step()

    def _kernel_step(self) -> None:
        """Every param group's update in one ``adam_l2_update`` call, over
        the parameters that have a gradient (as torch skips the others),
        their state created where it is missing as torch's capturable Adam
        creates it (step a 0-dim f32 on the parameter's device, moments
        zeros in the parameter's layout)."""
        for group in self.optimizer.param_groups:
            if group["amsgrad"] or group["maximize"]:
                raise ValueError("the optimizer kernel computes neither amsgrad nor maximize")
            params = [p for p in group["params"] if p.grad is not None]
            states = []
            for p in params:
                st = self.optimizer.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                states.append(st)
            b1, b2 = group["betas"]
            adam_l2_update(params, [p.grad for p in params], [st["exp_avg"] for st in states],
                           [st["exp_avg_sq"] for st in states], [st["step"] for st in states],
                           group["lr"], b1=b1, b2=b2, eps=group["eps"],
                           weight_decay=group["weight_decay"], ticket=self._ticket)

    def state_dict(self) -> dict:
        sd = self.optimizer.state_dict()
        for group in sd["param_groups"]:
            group["lr"] = float(group["lr"])
            group["capturable"] = False
        return sd

    def load_state_dict(self, state: dict) -> None:
        """Load a state, each moment in its parameter's layout (a state
        saved from NCHW parameters resumes channels-last ones, and the
        other way: the optimizer kernel, like torch's foreach kernels' fast
        path, needs a parameter and its moments to share strides); a capturable optimizer
        stays capturable (with new lr and state tensors, so a captured step
        must be captured again)."""
        self.optimizer.load_state_dict(state)
        for p in self.params:
            st = self.optimizer.state.get(p, {})
            for k, v in st.items():
                if torch.is_tensor(v) and v.shape == p.shape and v.stride() != p.stride():
                    st[k] = torch.empty_like(p, dtype=v.dtype).copy_(v)
        if self.capturable:
            self.make_capturable()


def adam_l2(params, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8, clip_grad_norm: float = 0.0) -> AdamL2:
    """torch-Adam with coupled L2 over ``params``, learning rate per step."""
    return AdamL2(params, weight_decay, b1, b2, eps, clip_grad_norm)
