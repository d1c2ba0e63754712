"""Residual feature blocks (NCHW, or NHWC as their input), named as the
reference's state_dict.

- ``MSRB``: multi-scale residual block -- parallel 3x3 and 5x5 conv-BN-ReLU,
  concat, parallel 3x3 and 5x5 at 2n channels, concat to 4n, 1x1
  ``confusion`` back to n, residual add, ReLU (reference
  model/tactileSR_model.py:157-214).  Keys ``conv_3_1.{0,1}`` ... and
  ``confusion``.
- ``ResBlock``: conv-ReLU-conv plus residual, ReLU (reference :216-225).
- ``LeakyResBlock``: conv-BN-leaky ReLU (slope 1.0, the identity) -
  conv-BN, residual add, leaky ReLU at ``negative_slope`` (0.2); bias-free
  convs; unused by the recipes but part of the reference's model surface
  (reference :227-241, the JAX package's ``blocks.py:64-80``).  Keys
  ``conv1``, ``bn1``, ``conv2``, ``bn2``.

Every conv of MSRB and ResBlock carries a bias (torch's Conv2d default).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv

__all__ = ["MSRB", "ResBlock", "LeakyResBlock"]


def _cbr(cin: int, cout: int, k: int) -> nn.Sequential:
    return nn.Sequential(Conv(cin, cout, k, padding=k // 2), BatchNorm(cout), nn.ReLU())


class MSRB(nn.Module):
    def __init__(self, n_feats: int = 64):
        super().__init__()
        n = n_feats
        self.conv_3_1 = _cbr(n, n, 3)
        self.conv_5_1 = _cbr(n, n, 5)
        self.conv_3_2 = _cbr(2 * n, 2 * n, 3)
        self.conv_5_2 = _cbr(2 * n, 2 * n, 5)
        self.confusion = Conv(4 * n, n, 1, padding=0)

    def forward(self, x):
        mid = torch.cat([self.conv_3_1(x), self.conv_5_1(x)], dim=1)
        fused = torch.cat([self.conv_3_2(mid), self.conv_5_2(mid)], dim=1)
        return torch.relu(self.confusion(fused) + x)


class ResBlock(nn.Module):
    def __init__(self, n_feats: int = 64):
        super().__init__()
        self.conv1 = Conv(n_feats, n_feats, 3)
        self.conv2 = Conv(n_feats, n_feats, 3)

    def forward(self, x):
        y = self.conv2(torch.relu(self.conv1(x)))
        return torch.relu(x + y)


class LeakyResBlock(nn.Module):
    def __init__(self, n_feats: int = 64, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.conv1 = Conv(n_feats, n_feats, 3, bias=False)
        self.bn1 = BatchNorm(n_feats)
        self.conv2 = Conv(n_feats, n_feats, 3, bias=False)
        self.bn2 = BatchNorm(n_feats)

    def forward(self, x):
        y = F.leaky_relu(self.bn1(self.conv1(x)), negative_slope=1.0)
        y = self.bn2(self.conv2(y))
        return F.leaky_relu(y + x, negative_slope=self.negative_slope)
