"""Plain float32 TactileSR (ToH 2024), written from the published model.

wmtlab/tactileSR ``model/tactileSR_model.py:18-98`` (TactileSR, the
``MSRB`` at :157-214, ``ResBlock`` at :216-225) in ``torch.nn`` modules
only: ``nn.Conv2d``, ``nn.BatchNorm2d``, ``nn.ReLU`` and
``F.interpolate`` (bilinear, ``align_corners=False``).  No fold, no fused
graph, no bucket, no capture.  The module names are the upstream
state_dict's, so one state_dict loads into this model and into the
program alike.

``forward(x, conv=...)`` takes the convolution to use: ``F.conv2d`` is
the reference; ``lowp.fp8_conv2d`` is the lower-precision control.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

TAXELS = 4  # the 4x4 taxel grid of the Xela sensor


def upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h * scale, w * scale), mode="bilinear", align_corners=False)


def resize(x: torch.Tensor, hw: int) -> torch.Tensor:
    """Bilinear resize without anti-aliasing (``nn.Upsample`` semantics)."""
    if x.shape[-2:] == (hw, hw):
        return x
    return F.interpolate(x, size=(hw, hw), mode="bilinear", align_corners=False, antialias=False)


def _apply(seq: nn.Sequential, x: torch.Tensor, conv) -> torch.Tensor:
    for m in seq:
        if isinstance(m, nn.Conv2d):
            x = conv(x, m.weight, m.bias, m.padding)
        else:
            x = m(x)
    return x


def _cbr(cin: int, cout: int, k: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, k, padding=k // 2), nn.BatchNorm2d(cout), nn.ReLU())


class MSRB(nn.Module):
    def __init__(self, n: int = 64):
        super().__init__()
        self.conv_3_1 = _cbr(n, n, 3)
        self.conv_5_1 = _cbr(n, n, 5)
        self.conv_3_2 = _cbr(2 * n, 2 * n, 3)
        self.conv_5_2 = _cbr(2 * n, 2 * n, 5)
        self.confusion = nn.Conv2d(4 * n, n, 1, padding=0)

    def forward(self, x, conv):
        mid = torch.cat([_apply(self.conv_3_1, x, conv), _apply(self.conv_5_1, x, conv)], dim=1)
        fused = torch.cat([_apply(self.conv_3_2, mid, conv), _apply(self.conv_5_2, mid, conv)], dim=1)
        c = self.confusion
        return torch.relu(conv(fused, c.weight, c.bias, c.padding) + x)


class ResBlock(nn.Module):
    def __init__(self, n: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(n, n, 3, padding=1)
        self.conv2 = nn.Conv2d(n, n, 3, padding=1)

    def forward(self, x, conv):
        y = torch.relu(conv(x, self.conv1.weight, self.conv1.bias, self.conv1.padding))
        y = conv(y, self.conv2.weight, self.conv2.bias, self.conv2.padding)
        return torch.relu(x + y)


class TactileSR(nn.Module):
    """STSR for ``seqs_cnt`` 1, MTSR above; (B, 3S, 4, 4) -> (B, 1, 4s, 4s)."""

    def __init__(self, scale_factor: int, seqs_cnt: int, axis_cnt: int, pattern_layers: int,
                 force_layers: int):
        super().__init__()
        self.scale, self.seqs, self.axis = scale_factor, seqs_cnt, axis_cnt

        def branch():
            return nn.Sequential(
                nn.Identity(),  # index 0 is the upsample, which has no parameters
                nn.Conv2d(axis_cnt, 64, 3, padding=1, bias=False), nn.BatchNorm2d(64), nn.ReLU(),
                nn.Conv2d(64, 64, 3, padding=1, bias=False), nn.BatchNorm2d(64), nn.ReLU())

        self.inputLayer_pattern_list = nn.ModuleList(branch() for _ in range(seqs_cnt))
        self.inputContact_layer = nn.Sequential(
            nn.Conv2d(64 * seqs_cnt, 64, 3, padding=1, bias=False), nn.BatchNorm2d(64), nn.ReLU())
        self.patternFeatureExtra_layer = nn.ModuleList(MSRB(64) for _ in range(pattern_layers))
        self.input_layer_force = nn.Sequential(
            nn.Identity(), nn.Conv2d(axis_cnt, 64, 3, padding=1, bias=False), nn.ReLU())
        self.forceFeatureExtra_layer = nn.ModuleList(ResBlock(64) for _ in range(force_layers))
        self.output_layer = nn.Sequential(
            nn.Conv2d(128, 128, 3, padding=1, bias=False), nn.ReLU(),
            nn.Conv2d(128, 1, 3, padding=1, bias=False), nn.ReLU())

    def forward(self, x: torch.Tensor, conv=None) -> torch.Tensor:
        conv = conv or (lambda x, w, b, p: F.conv2d(x, w, b, padding=p))
        a = self.axis
        x = x.float()
        pattern = torch.cat([_apply(br, upsample(x[:, s * a:(s + 1) * a], self.scale), conv)
                             for s, br in enumerate(self.inputLayer_pattern_list)], dim=1)
        pattern = _apply(self.inputContact_layer, pattern, conv)
        for blk in self.patternFeatureExtra_layer:
            pattern = blk(pattern, conv)
        force = _apply(self.input_layer_force, upsample(x[:, :a], self.scale), conv)
        for blk in self.forceFeatureExtra_layer:
            force = blk(force, conv)
        out = _apply(self.output_layer, torch.cat([force, pattern], dim=1), conv)
        return resize(out, TAXELS * self.scale)


def build(config: dict, device="cpu") -> TactileSR:
    """The reference network of a configuration file's widths, on
    ``device``, with torch's default initialisation (callers load a
    state_dict)."""
    with torch.device(device):
        return TactileSR(config["scale_factor"], config["seqsCnt"], config["axisCnt"],
                         config["patternFeatureExtraLayerCnt"], config["forceFeatureExtraLayerCnt"])


def sr_labels(hr: torch.Tensor, config: dict) -> torch.Tensor:
    """The loss's labels: HR / HR_scale_num resized to (4 scale)^2."""
    return resize(hr.float() / config["HR_scale_num"], TAXELS * config["scale_factor"])


def recipe_lrs(config: dict, epoch_len: int, steps: int) -> list:
    """The learning rates of a run's first ``steps`` iterations (all inside
    the first epoch and the warm-up): the recipe's StepLR by epoch, under
    a warm-up of ``warmup_t`` iterations that blends linearly from its start
    (``warmup_mode``: ``fix`` from ``warmup_init_lr`` to the base rate;
    ``factor`` the epoch's rate times a factor rising from
    ``warmup_factor`` to 1; ``auto`` from base x ``warmup_factor`` to the
    StepLR's rate at the warm-up's last epoch)."""
    base, t_w = config["lr"], config.get("warmup_t", 0)
    assert steps <= epoch_len and (not t_w or steps <= t_w)

    def step_lr(epoch: int) -> float:
        return base * config["lr_scheduler_gamma"] ** (epoch // config["lr_scheduler_step_size"])

    if not t_w:
        return [step_lr(0)] * steps
    mode, f = config["warmup_mode"], config.get("warmup_factor")
    blend = {"fix": lambda a: config["warmup_init_lr"] * (1 - a) + base * a,
             "factor": lambda a: step_lr(0) * (f * (1 - a) + a),
             "auto": lambda a: base * f * (1 - a) + step_lr(t_w // epoch_len) * a}[mode]
    return [blend(t / t_w) for t in range(steps)]


def train_steps(model: TactileSR, lr_rows: torch.Tensor, hr_rows: torch.Tensor, batches, config: dict,
                lrs, conv=None, keep=0):
    """Adam with coupled L2 weight decay (Kingma and Ba, the decay added to
    the gradient) over ``batches`` (index tensors) of the rows, the model in
    train mode (BatchNorm on batch statistics, running statistics updated
    with momentum 0.1 and the unbiased variance).  Updates ``model`` in
    place; returns (losses, the first step's gradient with its decay term,
    by parameter name).  ``keep`` > 0 keeps only that many rows of each
    batch (a fault: the mean over the rest)."""
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, config["weight_decay"]
    params = dict(model.named_parameters())
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    model.train()
    for t, (idx, lr) in enumerate(zip(batches, lrs), start=1):
        if keep:
            idx = idx[:keep]
        pred = model(lr_rows[idx], conv)
        label = sr_labels(hr_rows[idx], config)
        loss = ((pred - label) ** 2).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g_all = {k: g + wd * params[k] for k, g in zip(params, grads)}
            if first is None:
                first = {k: g.clone() for k, g in g_all.items()}
            for k, p in params.items():
                g = g_all[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                p.sub_(lr * (m[k] / (1 - b1 ** t)) / denom)
    return losses, first
