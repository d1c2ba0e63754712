"""The control: the reference's convolutions in fp8.

The configurations state bf16 (serving and training compute), so the
control is the next precision below: every convolution's input and kernel
rounded to float8 e4m3 with one scale per tensor (its largest magnitude
mapped to e4m3's 448), products summed in f32, as an fp8 GEMM does.  In
training the backward's output gradient is rounded to e5m2 (largest
magnitude to 57344) before both of its convolutions.  Everything else
(BatchNorm, resizes, ReLU, the loss, Adam) stays the f32 reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def quantize(x: torch.Tensor, fmt=E4M3) -> torch.Tensor:
    """``x`` rounded to fp8 with a per-tensor scale, returned in f32."""
    dtype, top = fmt
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / top
    return (x.float() / scale).to(dtype).float() * scale


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, padding):
        xq, wq = quantize(x), quantize(w)
        ctx.save_for_backward(xq, wq)
        ctx.padding = padding
        return F.conv2d(xq, wq, None, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = quantize(gy, E5M2)
        gx = conv2d_input(xq.shape, wq, gq, padding=ctx.padding)
        gw = conv2d_weight(xq, wq.shape, gq, padding=ctx.padding)
        return gx, gw, None


def fp8_conv2d(x, w, b, padding):
    """A ``reference.model`` convolution in fp8 (module docstring)."""
    y = _Fp8Conv.apply(x, w, tuple(padding) if not isinstance(padding, int) else padding)
    return y if b is None else y + b.view(1, -1, 1, 1)
