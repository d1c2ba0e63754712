"""Plain float32 tPSFNet (ToH 2024, stage 1), written from the published
direct form.

wmtlab/tactileSR ``model/tPSFNet.py:13-141``: an MLP (48 -> 256 -> 1024 ->
256 -> 3, ReLU, final Softplus; ``MLP_layer`` with its Linear layers at
indices 1, 3, 5, 7, the upstream state_dict names, so one state_dict loads
into this model and into the program alike) maps a flattened (3, 4, 4)
reading to (alpha, beta, m).  Then, per sample:
- the PSF ``alpha * exp(-sdf^2 / beta^2)`` on a 99x99 distance field from
  the centre, min-max scaled to [0, 10] (:43-46, :78-83);
- the HR map: the (100, 100) depth map ``ZeroPad2d(48)`` and
  ``F.conv2d(., psf, padding=1)`` to 100x100; the contact pixels (depth >
  max - 1e-3) take the second max, the largest HR value outside them,
  detached (:85-100);
- the reading: 16 taxel masks ``exp(-sdf^2 / m)`` on the distance fields
  from the taxel centres (12 + 25 i, 12 + 25 j), min-max scaled to [0, 10]
  jointly, the masks then min-max normalised jointly to [0, 1];
  ``LR[i, j] = sum(HR * mask[i, j]) * 1e-4`` (:49-55, :129-141).
The loss is the MSE of the reading against the real z-channel (the recipe's
``train_cal_loss``); the training steps are Adam with coupled L2 decay
(the decay added to the gradient), as the recipe's optimizer.  TF32 is off
in every function here.

Departures from upstream, none of which changes a sum:
- the batch: upstream loops over samples in Python (:118-126); here the PSF
  convolution is one grouped ``F.conv2d`` (groups = samples) over blocks of
  ``BLOCK`` samples, and the 16 masked sums are one einsum;
- ``forward`` takes the reading already divided by ``scale_num``, as the
  recipe feeds it, and returns (HR, LR, abm), without the PSF;
- an all-contact map (no pixel outside the contact) takes 0 there, the
  floor of the second max.

``physics_bf16`` is the lower-precision control: the same function in
separable form (``A D A^T`` with the banded Gaussian ``A``, ``U HR U^T``
with the taxel profiles ``U``), each of its four products' operands
rounded to bf16 and summed in f32, as one bf16 tensor-core pass computes
it; the contact pixels, the second max, the masks' normalisation and the
scale stay f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import tf32_off

PSF = 99  # the PSF field's side
HR = 100  # the depth and HR maps' side
PAD = 48  # ZeroPad2d(48): 196 wide, then a 99-tap conv with padding 1 gives 100
TAXELS = 4
CENTRE0, PITCH = 12, 25  # taxel centres at 12 + 25 i
DISTURBANCE = 1e-3  # contact: depth > max - 1e-3
DEGRADE = 1e-4
BLOCK = 64  # samples a grouped convolution takes at once


def _scaled(d: torch.Tensor) -> torch.Tensor:
    """A distance field min-max scaled to [0, 10] (jointly, over all of it)."""
    return 10 * (d - d.min()) / (d.max() - d.min())


def psf_field(device) -> torch.Tensor:
    """(99, 99) distances from the centre, scaled to [0, 10]."""
    r = torch.arange(PSF, dtype=torch.float32, device=device) - PSF // 2
    return _scaled(torch.sqrt(r[:, None] ** 2 + r[None, :] ** 2))


def taxel_fields(device) -> torch.Tensor:
    """(4, 4, 100, 100) distances from the 16 taxel centres, jointly scaled
    to [0, 10]."""
    x = torch.arange(HR, dtype=torch.float32, device=device)
    c = CENTRE0 + PITCH * torch.arange(TAXELS, dtype=torch.float32, device=device)
    d2 = (x[None, None, :, None] - c[:, None, None, None]) ** 2 + (x[None, None, None, :] - c[None, :, None, None]) ** 2
    return _scaled(torch.sqrt(d2))


def second_max(hr: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """The contact pixels of each (B, 100, 100) map set to the largest HR
    value outside them, detached."""
    contact = depth > depth.amax(dim=(-2, -1), keepdim=True) - DISTURBANCE
    outside = hr.detach().masked_fill(contact, 0).amax(dim=(-2, -1), keepdim=True)
    return torch.where(contact, outside, hr)


def render(depth: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """(B, 100, 100) depth -> HR by the PSF convolution, ``BLOCK`` samples a call."""
    psf = alpha.view(-1, 1, 1) * torch.exp(-psf_field(depth.device) ** 2 / beta.view(-1, 1, 1) ** 2)
    out = []
    for i in range(0, depth.shape[0], BLOCK):
        d, k = depth[i:i + BLOCK], psf[i:i + BLOCK]
        padded = F.pad(d, (PAD, PAD, PAD, PAD))[None]  # (1, n, 196, 196)
        out.append(F.conv2d(padded, k[:, None], padding=1, groups=d.shape[0])[0])
    return second_max(torch.cat(out), depth)


def degrade(hr: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(B, 100, 100) HR -> (B, 4, 4) readings through the 16 masks."""
    masks = torch.exp(-taxel_fields(hr.device)[None] ** 2 / m.view(-1, 1, 1, 1, 1))
    lo = masks.amin(dim=(1, 2, 3, 4), keepdim=True)
    hi = masks.amax(dim=(1, 2, 3, 4), keepdim=True)
    return torch.einsum("bhw,bijhw->bij", hr, (masks - lo) / (hi - lo)) * DEGRADE


def physics(depth: torch.Tensor, abm: torch.Tensor):
    """depth (B, 100, 100), abm (B, 3) -> (HR (B, 100, 100), LR (B, 4, 4))."""
    with tf32_off():
        depth, abm = depth.float(), abm.float()
        hr = render(depth, abm[:, 0], abm[:, 1])
        return hr, degrade(hr, abm[:, 2])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_bf16(a), _bf16(b))


def physics_bf16(depth: torch.Tensor, abm: torch.Tensor):
    """The control: ``physics`` with its four products in one bf16 pass
    (module docstring)."""
    with tf32_off():
        depth, abm = depth.float(), abm.float()
        alpha, beta, m = (abm[:, k].view(-1, 1, 1) for k in range(3))
        x = torch.arange(HR, dtype=torch.float32, device=depth.device)
        off = x[None, :] - x[:, None]  # raw row j feeds output row i at offset j - i
        step = 10 / (math.sqrt(2) * (PSF // 2))  # the PSF field's scale: one pixel's distance
        band = torch.where(off.abs() <= PSF // 2, torch.exp(-(step * off) ** 2 / beta ** 2), 0.0)
        hr = second_max(alpha * _dot(_dot(band, depth), band.transpose(-2, -1)), depth)
        c = CENTRE0 + PITCH * torch.arange(TAXELS, dtype=torch.float32, device=depth.device)
        step_m = 10 / (math.sqrt(2) * (HR - 1 - CENTRE0))  # the taxel fields' joint scale
        u = torch.exp(-(step_m * (x[None, :] - c[:, None])) ** 2 / m)  # (B, 4, 100)
        low = torch.exp(-100 / m)  # the masks' joint minimum (field 10); their maximum is 1
        total = hr.sum(dim=(-2, -1), keepdim=True)
        lr = (_dot(_dot(u, hr), u.transpose(-2, -1)) - low * total) / (1 - low) * DEGRADE
        return hr, lr


class TPSFNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.MLP_layer = nn.Sequential(
            nn.Flatten(), nn.Linear(48, 256), nn.ReLU(), nn.Linear(256, 1024), nn.ReLU(),
            nn.Linear(1024, 256), nn.ReLU(), nn.Linear(256, 3), nn.Softplus())

    def forward(self, x: torch.Tensor, depth: torch.Tensor, physics_fn=physics):
        """x (B, 3, 4, 4) reading / scale_num, depth (B, 100, 100) ->
        (HR (B, 100, 100), LR (B, 4, 4), abm (B, 3))."""
        with tf32_off():
            abm = self.MLP_layer(x.float())
        hr, lr = physics_fn(depth, abm)
        return hr, lr, abm


def build(device="cpu") -> TPSFNet:
    """The reference network on ``device`` (callers load a state_dict)."""
    with torch.device(device):
        return TPSFNet()


def loss(lr: torch.Tensor, reading: torch.Tensor) -> torch.Tensor:
    """MSE of the (B, 4, 4) predicted reading against the z-channel of the
    (B, 3, 4, 4) reading / scale_num."""
    return ((lr - reading[:, 2].float()) ** 2).mean()


def train_steps(model: TPSFNet, readings: torch.Tensor, depth, batches, lrs, weight_decay: float,
                scale_num: float, physics_fn=physics, keep: int = 0):
    """Adam with coupled L2 decay over ``batches`` (index tensors into the
    rows; ``depth(idx)`` gives their (n, 100, 100) maps) at the rates
    ``lrs``.  Updates ``model`` in place; returns (losses, the first step's
    gradient with its decay term, by parameter name).  ``keep`` > 0 keeps
    only that many rows of each batch (a fault: the mean over the rest)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    params = dict(model.named_parameters())
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    for t, (idx, lr) in enumerate(zip(batches, lrs), start=1):
        if keep:
            idx = idx[:keep]
        x = readings[idx].float() / scale_num
        _hr, pred, _abm = model(x, depth(idx), physics_fn)
        with tf32_off():
            value = loss(pred, x)
            grads = torch.autograd.grad(value, list(params.values()))
        losses.append(float(value.detach()))
        with torch.no_grad():
            g_all = {k: g + weight_decay * params[k] for k, g in zip(params, grads)}
            if first is None:
                first = {k: g.clone() for k, g in g_all.items()}
            for k, p in params.items():
                g = g_all[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                p.sub_(lr * (m[k] / (1 - b1 ** t)) / denom)
    return losses, first


def physics_grad(depth: torch.Tensor, abm: torch.Tensor, g_lr: torch.Tensor, physics_fn=physics):
    """(HR, LR, the abm gradient under the LR cotangent ``g_lr``) by autograd."""
    a = abm.detach().float().clone().requires_grad_(True)
    hr, lr = physics_fn(depth, a)
    with tf32_off():
        (g,) = torch.autograd.grad(lr, a, g_lr)
    return hr.detach(), lr.detach(), g
