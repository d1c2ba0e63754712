"""Pieces the drivers share: the seeded checkpoint the program loads, the
reference's outputs in blocks, and the device's peak memory."""

from __future__ import annotations

import contextlib
import os

import torch

from .reference.compare import serving_numbers
from .reference.model import build


@contextlib.contextmanager
def tf32_off():
    """Full f32 for matmuls and cuDNN convolutions inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def write_checkpoint(state_dict: dict, scratch: str) -> str:
    """The seeded weights as a checkpoint file the program loads."""
    path = os.path.join(scratch, "weights.pth")
    torch.save({"model": {k: v.cpu() for k, v in state_dict.items()}}, path)
    return path


def program_widths(config: dict) -> dict:
    """The serving entry's keyword arguments for a configuration file."""
    return dict(scale_factor=config["scale_factor"], seqs_cnt=config["seqsCnt"], axis_cnt=config["axisCnt"],
                pattern_layers=config["patternFeatureExtraLayerCnt"],
                force_layers=config["forceFeatureExtraLayerCnt"], compute_dtype=config["compute_dtype"])


def peak_memory(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free_program(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


@torch.no_grad()
def reference_outputs(config: dict, state_dict: dict, frames: torch.Tensor, conv=None, block: int = 512):
    """The f32 reference (TF32 off) over ``frames``, ``block`` rows at a time."""
    model = build(config, frames.device)
    model.load_state_dict(state_dict)
    model.eval()
    with tf32_off():
        return torch.cat([model(frames[i:i + block], conv) for i in range(0, frames.shape[0], block)])


def serving_check(config: dict, state_dict: dict, frames, answers, device, conv=None) -> dict:
    """``serving_numbers`` of the served ``answers`` to host ``frames``."""
    x = torch.from_numpy(frames).to(device)
    ref = reference_outputs(config, state_dict, x, conv)
    return serving_numbers(torch.from_numpy(answers).to(device), ref)


def serving_control(config: dict, seed: int, frames, device) -> dict:
    """The control's numbers: the reference with fp8 convolutions in the
    program's place, judged against the f32 reference on ``frames``."""
    from .reference.lowp import fp8_conv2d
    from .weights import seeded_state_dict

    state = seeded_state_dict(config, seed, device)
    x = torch.from_numpy(frames).to(device)
    ref = reference_outputs(config, state, x)
    return serving_numbers(reference_outputs(config, state, x, fp8_conv2d), ref)
