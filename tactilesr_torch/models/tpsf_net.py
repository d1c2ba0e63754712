"""tPSFNet: the learned point-spread-function physics model (ToH 2024 stage 1).

An MLP (48 -> 256 -> 1024 -> 256 -> 3, ReLU, final Softplus) maps a
flattened (3, 4, 4) LR reading to (alpha, beta, m); the Gaussian PSF renders
a depth map into an HR contact map, and the taxel degradation projects it
back to a 4x4 reading (reference model/tPSFNet.py:13-141).

    forward(LR (B,3,4,4), depth (B,1,100,100)) ->
        (HR (B,1,100,100), LR_degrade (B,1,4,4), psf (B,1,99,99) or None,
         alpha_beta (B,1,3))

The MLP is ``MLP_layer`` with Linear layers at indices 1, 3, 5, 7 (the
reference's state_dict names).  Its layers compute in ``dtype`` with f32
parameters, as the JAX package's ``Dense(dtype=...)`` does; the MLP output
is cast to f32 before the softplus, and the physics always gets f32.  The
physics runs through the CUDA kernel on a GPU (differentiable through
``ops/cuda::tpsf_physics_fused``) and its plain version on the CPU
(``ops/psf.py``), its products at ``physics_precision`` (highest, high or
default; ``ops/psf.py::resolve_physics_precision``), as JAX's
``TPSFNet.physics_precision``; with ``use_kernel=False`` the physics is the
plain f32 version whatever ``physics_precision`` says.
``gama`` and ``perception_scale`` are stored but unused, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.psf import resolve_physics_precision, tpsf_forward_physics
from .layers import init_weights_

__all__ = ["TPSFNet", "Dense"]


class Dense(nn.Linear):
    """Linear layer with f32 parameters computing in ``dtype``: input, weight
    and bias are cast to it, and the bias is added after the product is
    rounded, as flax's ``nn.Dense`` does."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class TPSFNet(nn.Module):
    def __init__(
        self,
        gama: float = 1.4,
        perception_scale: Optional[float] = None,
        use_kernel="auto",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
        physics_precision=None,
    ):
        super().__init__()
        self.gama = gama
        self.perception_scale = perception_scale
        self.use_kernel = use_kernel
        self.physics_precision = resolve_physics_precision(physics_precision)
        self.dtype = dtype
        self.MLP_layer = nn.Sequential(
            nn.Flatten(),
            Dense(48, 256, dtype), nn.ReLU(),
            Dense(256, 1024, dtype), nn.ReLU(),
            Dense(1024, 256, dtype), nn.ReLU(),
            Dense(256, 3, dtype),
        )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights_(self, generator)

    def forward(self, x: torch.Tensor, depth: torch.Tensor, return_psf: bool = True):
        if x.shape[0] != depth.shape[0]:
            raise ValueError("batch size of LR tactile and depth must be the same")
        b = x.shape[0]
        alpha_beta = F.softplus(self.MLP_layer(x).float())
        depth2d = depth.reshape(b, depth.shape[-2], depth.shape[-1])
        hr, lr_degrade, psf = tpsf_forward_physics(
            depth2d, alpha_beta, return_psf=return_psf, use_kernel=self.use_kernel,
            precision=self.physics_precision,
        )
        if psf is not None:
            psf = psf[:, None]
        return hr[:, None], lr_degrade[:, None], psf, alpha_beta[:, None]
