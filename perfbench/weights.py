"""Seeded weights for the benchmarked network, drawn on the device.

Two generator calls on ``device`` (one normal, one uniform buffer), sliced
by leaf of the upstream state_dict layout:
- conv kernels: Kaiming normal, fan_out (the upstream init); the last head
  kernel ``output_layer.2`` folded to |w| / sqrt(fan_in), so that the
  head's ReLU is not born dead and the reference's output is not all zero,
  then scaled so that the reference's mean output over the frames below is
  the configuration's ``output_mean`` (the labels' mean, as a trained
  network's is: a first training step then starts from a loss of the
  labels' order, not from a far-off output's);
- conv biases: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's);
- BatchNorm: weight U(0.5, 1.5), bias U(-0.1, 0.1); the running mean
  and variance are those of one train-mode forward of the f32 reference
  over 64 frames U(0, 4) drawn from the same generator (momentum 1): not
  the init's 0 and 1, so that serving's fold does real work, and matched
  to the activations as a trained network's are, so that the output keeps
  the labels' scale (tens) and is not all zero.
"""

from __future__ import annotations

import math

import torch

from .reference.model import build

HEAD = "output_layer.2.weight"
_STATS = ("running_mean", "running_var", "num_batches_tracked")


def seeded_state_dict(config: dict, seed: int, device) -> dict:
    """{name: tensor} in f32 (``num_batches_tracked`` int64) on ``device``."""
    shapes = {k: v.shape for k, v in build(config, "meta").state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    normal_keys = [k for k, s in shapes.items() if len(s) == 4]
    uniform_keys = [k for k, s in shapes.items() if len(s) == 1 and not k.endswith(_STATS)]
    normal = torch.randn(sum(math.prod(shapes[k]) for k in normal_keys), generator=gen, device=device)
    uniform = torch.rand(sum(math.prod(shapes[k]) for k in uniform_keys), generator=gen, device=device)
    out, i, j = {}, 0, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        if k in normal_keys:
            x = normal[i:i + n].view(shape)
            i += n
            x = x * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            if k == HEAD:
                x = x.abs() / math.sqrt(shape[1] * shape[2] * shape[3])
        elif k in uniform_keys:
            u = uniform[j:j + n].view(shape)
            j += n
            if k.endswith("bias") and k.replace("bias", "weight") in shapes \
                    and len(shapes[k.replace("bias", "weight")]) == 4:
                w = shapes[k.replace("bias", "weight")]
                x = (2 * u - 1) / math.sqrt(w[1] * w[2] * w[3])
            elif k.endswith("bias"):
                x = (2 * u - 1) * 0.1
            else:
                x = 0.5 + u
        elif k.endswith("num_batches_tracked"):
            x = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            x = torch.zeros(shape, device=device) if k.endswith("mean") else torch.ones(shape, device=device)
        out[k] = x.contiguous()
    frames = 4 * torch.rand((64, config["seqsCnt"] * config["axisCnt"], 4, 4), generator=gen, device=device)
    model = build(config, device)
    model.load_state_dict(out)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad():
        model.train()(frames)
        head = dict(model.named_parameters())[HEAD]
        head.mul_(config["output_mean"] / model.eval()(frames).mean())
    return {k: v.detach().clone().zero_() if k.endswith("num_batches_tracked") else v.detach().clone()
            for k, v in model.state_dict().items()}
