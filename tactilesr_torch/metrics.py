"""Evaluation metrics with the reference's definitions (the port's copy of
``tactilesr_tpu/metrics.py``).

- PSNR: ``10*log10(max_value^2 / MSE)`` over one (H, W) map (reference
  utility/tools.py:49-63; the entry scripts pass max_value 250).
- SSIM: global statistics, one mean/variance/covariance over the whole map
  and no sliding window (reference utility/tools.py:66-81), C1 = 0.01^2,
  C2 = 0.03^2, variances in one pass as E[x^2] - mu^2.

The batched forms take (B, H, W) and return (B,).  All are differentiable.
"""

from __future__ import annotations

import torch

__all__ = ["psnr", "ssim", "batched_psnr", "batched_ssim", "mse", "ssim_loss"]

_HW = (-2, -1)


def mse(a, b) -> torch.Tensor:
    return ((torch.as_tensor(a).float() - torch.as_tensor(b).float()) ** 2).mean()


def batched_psnr(pattern1, pattern2, max_value: float) -> torch.Tensor:
    """(B, H, W) pairs -> (B,) PSNR."""
    err = ((torch.as_tensor(pattern1).float() - torch.as_tensor(pattern2).float()) ** 2).mean(_HW)
    return 10.0 * torch.log10((max_value * max_value) / err)


def batched_ssim(pattern1, pattern2, c1: float = 0.01**2, c2: float = 0.03**2) -> torch.Tensor:
    """(B, H, W) pairs -> (B,) global SSIM."""
    x = torch.as_tensor(pattern1).float()
    y = torch.as_tensor(pattern2).float()
    mu1, mu2 = x.mean(_HW), y.mean(_HW)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = (x * x).mean(_HW) - mu1_sq
    sigma2_sq = (y * y).mean(_HW) - mu2_sq
    sigma12 = (x * y).mean(_HW) - mu1_mu2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )


def psnr(pattern1, pattern2, max_value: float) -> torch.Tensor:
    """PSNR of one (H, W) map."""
    return batched_psnr(torch.as_tensor(pattern1)[None], torch.as_tensor(pattern2)[None], max_value)[0]


def ssim(pattern1, pattern2, c1: float = 0.01**2, c2: float = 0.03**2) -> torch.Tensor:
    """Global (non-windowed) SSIM of one (H, W) map."""
    return batched_ssim(torch.as_tensor(pattern1)[None], torch.as_tensor(pattern2)[None], c1, c2)[0]


def ssim_loss(img1, img2) -> torch.Tensor:
    """1 - SSIM, a minimizable loss (the reference's SSIM loss module,
    utility/tools.py:85-114)."""
    return 1.0 - ssim(img1, img2)
