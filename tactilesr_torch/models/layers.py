"""Primitive layers with the JAX package's initializers and dtype rules.

The reference initializes every Conv2d with Kaiming-normal fan_out and
every BatchNorm2d with weight = bias = 0.1 (reference
model/tactileSR_model.py:92-98); conv and linear biases keep torch's
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); tPSFNet's Linear weights (the JAX
package's ``Dense``) are N(0, 0.03).

Parameters stay f32.  ``Conv`` computes in its input's dtype (weights cast
at the call) and ``BatchNorm`` normalizes in f32 and casts back, so a bf16
activation stream matches the JAX modules' ``dtype`` rule.  Every
initializer draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Conv", "BatchNorm", "kaiming_normal_fan_out_", "non_negative_kaiming_fan_out_",
           "init_weights_"]


class Conv(nn.Conv2d):
    """Square-kernel, stride-1 conv (NCHW) computing in the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, padding: int = 1,
                 bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size, padding=padding, bias=bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, padding=self.padding)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (momentum 0.1, eps 1e-5) normalizing in f32.

    ``sync`` is set by the trainer on a data-parallel mesh of more than one
    rank (each rank a block of the global batch).  Then, in train mode, the
    statistics are the global batch's, as JAX's ``BatchNorm`` takes them over
    a sharded array: each rank's f32 sum, sum of squares and count go through
    one autograd-aware ``all_reduce`` over the process group, the variance is
    JAX's one-pass max(E[x^2] - E[x]^2, 0), and the running variance takes
    the unbiased n/(n-1) of the global n.  ``torch.nn.SyncBatchNorm`` is not
    used: it refuses CPU tensors and computes its variance another way.
    Unset, the layer is ``nn.BatchNorm2d``'s own path, whatever process
    group exists."""

    sync = False

    def forward(self, x):
        if self.training and self.sync:
            return self._global_batch_forward(x)
        return super().forward(x.float()).to(x.dtype)

    def _global_batch_forward(self, x):
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        c = xf.shape[1]
        count = torch.full((1,), xf.numel() // c, dtype=torch.float32, device=xf.device)
        local = torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)), count])
        with warnings.catch_warnings():  # deprecated in favour of a form without autograd
            warnings.simplefilter("ignore", FutureWarning)
            total = all_reduce(local)
        n = total[2 * c]
        mean = total[:c] / n
        var = torch.clamp(total[c:2 * c] / n - mean.square(), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * n / torch.clamp(n - 1, min=1.0))
            self.num_batches_tracked.add_(1)
        shape = (1, c, 1, 1)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


def kaiming_normal_fan_out_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """N(0, 2 / fan_out) with fan_out = out_channels * kh * kw."""
    fan_out = w.shape[0] * math.prod(w.shape[2:])
    with torch.no_grad():
        return w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def non_negative_kaiming_fan_out_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """|Kaiming fan_out| / sqrt(fan_in), fan_in = in_channels * kh * kw.

    The SR head is conv (no bias) -> ReLU on ReLU features: an all-positive
    kernel can never be born dead, and the 1/sqrt(fan_in) keeps its output
    at the scale of a sign-random draw (the JAX package's
    ``non_negative_kaiming_fan_out``)."""
    return fold_non_negative_(kaiming_normal_fan_out_(w, generator))


def fold_non_negative_(w: torch.Tensor) -> torch.Tensor:
    """In place: a Kaiming draw ``w`` -> |w| / sqrt(fan_in)."""
    with torch.no_grad():
        return w.abs_().div_(math.sqrt(math.prod(w.shape[1:]) or 1))


def _bias_uniform_(b: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        b.uniform_(-bound, bound, generator=generator)


DENSE_STD = 0.03  # reference model/tPSFNet.py:64-65


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Apply the JAX package's initializers to every layer, in module order."""
    for mod in module.modules():
        if isinstance(mod, nn.Conv2d):
            kaiming_normal_fan_out_(mod.weight, generator)
            if mod.bias is not None:
                _bias_uniform_(mod.bias, math.prod(mod.weight.shape[1:]), generator)
        elif isinstance(mod, nn.BatchNorm2d):
            with torch.no_grad():
                mod.weight.fill_(0.1)
                mod.bias.fill_(0.1)
            mod.reset_running_stats()
        elif isinstance(mod, nn.Linear):
            with torch.no_grad():
                mod.weight.normal_(0.0, DENSE_STD, generator=generator)
            _bias_uniform_(mod.bias, mod.weight.shape[1], generator)
    return module
